"""Linear-algebra ops (counterpart of ``mxnet_tpu.ops.linalg``): the
``_linalg_*`` family of ``la_op.cc`` and ``khatri_rao``, each on
``torch.linalg`` (cuSOLVER and cuBLAS on the card) and batched over the
leading axes.  ``gemm2``, ``potrf``, ``syrk`` and ``trsm`` are in
``tensor.py``, as in the reference.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(a):
    return torch.swapaxes(a, -1, -2)


@register("linalg_gemm", aliases=("_linalg_gemm",))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2, **_):
    """``alpha * op(A) op(B) + beta * C``."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_potri", aliases=("_linalg_potri",))
def _linalg_potri(A, **_):
    """``(L L^T)^-1`` from the lower Cholesky factor ``L``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    linv = torch.linalg.solve_triangular(A, eye.expand(A.shape), upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trmm", aliases=("_linalg_trmm",))
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **_):
    """``alpha * op(A) B`` (``B op(A)`` with ``rightside``) with ``A``'s
    ``lower`` (or upper) triangle."""
    a = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        a = _t(a)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_sumlogdiag", aliases=("_linalg_sumlogdiag",))
def _linalg_sumlogdiag(A, **_):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_extractdiag", aliases=("_linalg_extractdiag",))
def _linalg_extractdiag(A, offset=0, **_):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag", aliases=("_linalg_makediag",))
def _linalg_makediag(A, offset=0, **_):
    return torch.diag_embed(A, offset=offset)


def _trian_indices(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("linalg_extracttrian", aliases=("_linalg_extracttrian",))
def _linalg_extracttrian(A, offset=0, lower=True, **_):
    """A triangle of each matrix packed row by row into a vector."""
    r, c = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., r, c]


@register("linalg_maketrian", aliases=("_linalg_maketrian",))
def _linalg_maketrian(A, offset=0, lower=True, **_):
    """The inverse of ``extracttrian``: the packed vector unpacked into a
    triangular matrix of the size it fills."""
    m = A.shape[-1]
    n = int((-1 + (1 + 8 * m) ** 0.5) / 2) + abs(offset)
    r, c = _trian_indices(n, offset, lower, A.device)
    out = torch.zeros(A.shape[:-1] + (n, n), dtype=A.dtype, device=A.device)
    return _put_trian(out, r, c, A)


def _put_trian(out, r, c, vals):
    flat = out.reshape(out.shape[:-2] + (-1,))
    idx = (r * out.shape[-1] + c).expand(vals.shape)
    return flat.scatter(-1, idx, vals).reshape(out.shape)


@register("linalg_gelqf", aliases=("_linalg_gelqf",), num_outputs=2)
def _linalg_gelqf(A, **_):
    """``A = L Q`` with ``Q``'s rows orthonormal, from the QR of
    ``A^T``; returns ``(L, Q)``."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_syevd", aliases=("_linalg_syevd",), num_outputs=2)
def _linalg_syevd(A, **_):
    """``(U, lam)`` with ``A = U^T diag(lam) U``: the rows of ``U`` are
    the eigenvectors, ascending eigenvalues (a row's sign is the
    solver's)."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("linalg_inverse", aliases=("_linalg_inverse", "inverse"))
def _linalg_inverse(A, **_):
    return torch.linalg.inv(A)


@register("linalg_det", aliases=("_linalg_det", "det"))
def _linalg_det(A, **_):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("_linalg_slogdet", "slogdet"),
          num_outputs=2)
def _linalg_slogdet(A, **_):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("khatri_rao")
def _khatri_rao(*matrices, **_):
    """The column-wise Kronecker product."""
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out
