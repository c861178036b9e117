"""FFT ops (counterpart of ``mxnet_tpu.ops.signal``; reference
``src/operator/contrib/fft-inl.h`` / ``ifft-inl.h``): a complex transform
over the last axis with the (re, im) pairs interleaved, ``(..., n)`` real
to ``(..., 2n)``, unnormalised both ways (``ifft(fft(x)) == n * x``).
The transform runs in f32 and is cast back to the input's dtype (cuFFT
takes no bf16)."""
from __future__ import annotations

import torch

from .registry import register


@register("_contrib_fft", aliases=("fft",))
def _fft(data, compute_size=128, **_):
    """Real ``(..., n)`` to interleaved complex ``(..., 2n)``."""
    f = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)
                       ).to(data.dtype)


@register("_contrib_ifft", aliases=("ifft",))
def _ifft(data, compute_size=128, **_):
    """Interleaved complex ``(..., 2n)`` to real ``(..., n)``, scaled by
    ``n``."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2)).to(torch.float32)
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(z, dim=-1).real * n).to(data.dtype)
