"""TransformerLM — decoder-only language model with paged-KV generation
(counterpart of ``mxnet_tpu.models.transformer``).

An ``nn.Module`` that owns its weights, in the reference's stacked
parameter layout (``wqkv [L, D, 3, H, Dh]``, ``wo [L, H, Dh, D]``,
``w1 [L, D, F]``, ``w2 [L, F, D]``, ``ln1``/``ln2 [L, D]``, ``embed
[V, D]``, ``pos_embed [max_len, D]``, ``final_norm [D]``), so
``convert.params_from_reference`` carries the reference's weights across
unchanged.  The reference's ``lax.scan`` over layers is
``runtime.scan_stack``, a Python loop over the stacked weights
(:meth:`TransformerLM.run_stack`, the encoder body BERT shares).

Over a mesh (``mesh=``, one process a rank) the model takes the
reference's axes: the batch over ``dp``, attention heads and MLP columns
over ``tp`` (Megatron's splits, :meth:`TransformerLM.param_specs`), the
sequence over ``sp`` in contiguous blocks (ring attention).  Each rank
holds its block of every weight: ``wqkv`` and ``wo`` split on heads,
``w1`` on ``d_ff`` columns, ``w2`` on ``d_ff`` rows, the rest whole.  A
layer makes one sum over ``tp`` after ``wo`` and one after ``w2``, of
the f32 partial products before the cast to the model's dtype (the
reference's einsums accumulate in f32 and cast after), and the local
heads run through ``kernels.attention`` when ``sp`` has one rank, else
through ``parallel.ring_attention``.  The loss and the forward take the
GLOBAL token arrays on every rank and use this rank's block; the loss is
the mean over the global batch.  After ``backward()``,
:meth:`TransformerLM.allreduce_grads` sums the gradients over ``dp`` and
``sp`` (the ranks with other tokens), never over ``tp``: under
Megatron's pair of collectives a weight every rank holds whole already
has the same gradient on each ``tp`` rank.

Generation runs over the same mesh.  The page pool holds the rank's
heads (``[L, pages, page_size, H / tp, Dh]``, and the int8 pool's row
scales ``[L, pages, page_size, H / tp]``), whole over ``dp`` and ``sp``;
every rank passes the global prompts, table and tokens and gets the
global next tokens and logits.  A ``dp`` rank runs its rows and writes
only their pages.  Prefill runs the local heads through
``kernels.attention`` when ``sp`` has one rank, else through ring
attention over its sequence block, whose K/V blocks are gathered over
``sp`` before the page writes, so every ``sp`` rank's pool holds the
whole prompt.  A decode step runs the local heads through
``kernels.paged_attention_pool`` and sums over ``tp`` after ``wo`` and
after ``w2``, as the training forward does; ``sp`` ranks repeat it.

Generation state is a POOL of fixed-size KV pages shared by every
in-flight sequence; each sequence owns a page-table row of page ids.
Position ``t`` lives at slot ``t % page_size`` of page
``table[t // page_size]``.  A page id ``>= num_pages`` is the SENTINEL:
writes through it are dropped and gathers through it are clamped to the
last real page, whose rows the position mask then zeroes out — the
reference's ``mode="drop"`` scatter and clamping gather, done
explicitly.  The pool is updated IN PLACE: the analog of the reference
donating the pool into every program.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels as _kernels
from .. import runtime as _runtime
from ..context import resolve_device
from ..parallel import collectives as _coll
from ..parallel.mesh import PartitionSpec as P
from ..parallel.ring_attention import ring_attention
from ..quantization import quantize_rows

__all__ = ["TransformerLMConfig", "TransformerLM", "gumbel_noise"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


def dtype_name(d):
    return str(_dtype(d)).replace("torch.", "")


class TransformerLMConfig:
    def __init__(self, vocab_size=32000, num_layers=12, d_model=768,
                 num_heads=12, d_ff=3072, max_len=2048,
                 dtype=torch.bfloat16, causal=True):
        if d_model % num_heads:
            raise ValueError("d_model %d not divisible by num_heads %d"
                             % (d_model, num_heads))
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.d_ff = d_ff
        self.max_len = max_len
        self.dtype = _dtype(dtype)
        self.causal = causal

    def to_dict(self):
        return {"vocab_size": self.vocab_size, "num_layers": self.num_layers,
                "d_model": self.d_model, "num_heads": self.num_heads,
                "d_ff": self.d_ff, "max_len": self.max_len,
                "dtype": dtype_name(self.dtype), "causal": self.causal}


def _norm(x, scale, eps=1e-6):
    # RMSNorm in f32, output in the model dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


_MASK64 = (1 << 64) - 1


def _fold_seed(k0, k1, pos):
    """Request key words folded with a token position into one 63-bit
    generator seed (splitmix64 finaliser)."""
    x = (((int(k0) << 32) | int(k1))
         ^ ((int(pos) + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def gumbel_noise(keys, positions, vocab, device):
    """Gumbel(0, 1) noise ``[B, vocab]`` f32: row ``b`` comes from its own
    ``torch.Generator`` seeded by the request key ``keys[b]`` (two uint32
    words) folded with ``positions[b]``, so one request seed yields one
    stream whatever else shares the batch."""
    rows = []
    tiny = torch.finfo(torch.float32).tiny
    for (k0, k1), pos in zip(_np.asarray(keys).reshape(-1, 2).tolist(),
                             _np.asarray(positions).reshape(-1).tolist()):
        g = torch.Generator(device=device)
        g.manual_seed(_fold_seed(k0, k1, pos))
        u = torch.rand(vocab, generator=g, device=device,
                       dtype=torch.float32).clamp_min(tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else _np.asarray(x)


#: the stacked per-layer weights, in the reference's order
LAYER_NAMES = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")
#: the norm scales, which :meth:`TransformerLM.init` sets to one
_UNIT_SCALES = ("ln1", "ln2", "final_norm")


class _Layers(nn.Module):
    """The per-layer weights, stacked over layers (reference layout); a
    ``tp``-way split holds ``H / tp`` heads and ``d_ff / tp`` MLP
    columns."""

    def __init__(self, cfg, device, tp=1):
        super().__init__()
        L, D, F_, H, Dh = (cfg.num_layers, cfg.d_model, cfg.d_ff // tp,
                           cfg.num_heads // tp, cfg.head_dim)

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=cfg.dtype,
                                            device=device),
                                requires_grad=False)

        self.ln1 = p(L, D)
        self.wqkv = p(L, D, 3, H, Dh)
        self.wo = p(L, H, Dh, D)
        self.ln2 = p(L, D)
        self.w1 = p(L, D, F_)
        self.w2 = p(L, F_, D)


@torch.no_grad()
def init_weights(model, seed, ones, zeros=()):
    """``model``'s weights from ``seed``: the parameters named (last
    component) in ``ones`` set to 1, in ``zeros`` to 0, the rest
    normal(0, 0.02) drawn in ``named_parameters`` order.  Over a mesh each
    rank draws the whole tensors and keeps its blocks
    (``model.flat_specs()``), so the weights are the one-rank model's.
    Returns ``model``."""
    g = torch.Generator(device=model.device)
    g.manual_seed(int(seed))
    mesh = model.mesh
    specs = model.flat_specs() if mesh is not None else {}
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ones or leaf in zeros:
            prm.fill_(1.0 if leaf in ones else 0.0)
            continue
        spec = specs.get(name, ())
        shape = tuple(n * mesh.axis_size(spec[d]) if d < len(spec) else n
                      for d, n in enumerate(prm.shape))
        w = torch.randn(shape, generator=g, device=model.device,
                        dtype=torch.float32) * 0.02
        prm.copy_(_coll.local_block(w, mesh, spec) if spec else w)
    return model


def _mesh_axis(mesh, name):
    """``name`` when ``mesh`` has it with more than one rank, else None."""
    if mesh is not None and mesh.shape.get(name, 1) > 1:
        return name
    return None


class TransformerLM(nn.Module):
    """Decoder-only transformer over stacked layer weights.

    ``device`` defaults to ``cuda:0`` (``mesh.device`` with a mesh) and
    raises without a GPU; pass ``device="cpu"`` to run on the CPU.
    ``mesh`` splits the model over its ``dp`` / ``tp`` / ``sp`` axes
    (module docstring).  ``self.gumbel`` is the sampler's noise source
    (:func:`gumbel_noise`); tests replace it to feed both packages
    identical noise."""

    def __init__(self, config, mesh=None, device=None):
        super().__init__()
        self.cfg = config
        self.mesh = mesh
        names = mesh.axis_names if mesh is not None else ()
        self._dp = "dp" if "dp" in names else None
        self._tp = "tp" if "tp" in names else None
        self._sp = "sp" if "sp" in names else None
        self._tp_live = _mesh_axis(mesh, "tp")
        self._sp_live = _mesh_axis(mesh, "sp")
        self._batch_live = tuple(a for a in ("dp", "sp")
                                 if _mesh_axis(mesh, a))
        tp = mesh.shape["tp"] if self._tp_live else 1
        if config.num_heads % tp or config.d_ff % tp:
            raise ValueError("num_heads %d and d_ff %d must split over tp=%d"
                             % (config.num_heads, config.d_ff, tp))
        if device is None and mesh is not None:
            device = mesh.device
        dev = resolve_device(device)
        V, D, S = config.vocab_size, config.d_model, config.max_len

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=config.dtype,
                                            device=dev),
                                requires_grad=False)

        self.embed = p(V, D)
        self.pos_embed = p(S, D)
        self.final_norm = p(D)
        self.layers = _Layers(config, dev, tp)
        self.gumbel = gumbel_noise

    @property
    def device(self):
        return self.embed.device

    # -------------------------------------------------------------- params
    def param_specs(self):
        """The PartitionSpec of each parameter, in the reference's nested
        layout: Megatron's column and row splits on ``tp``."""
        tp = self._tp
        return {
            "embed": P(None, None),
            "pos_embed": P(None, None),
            "final_norm": P(None),
            "layers": {
                "ln1": P(None, None),
                "wqkv": P(None, None, None, tp, None),
                "wo": P(None, tp, None, None),
                "ln2": P(None, None),
                "w1": P(None, None, tp),
                "w2": P(None, tp, None),
            },
        }

    def flat_specs(self):
        """:meth:`param_specs` under the state dict's names
        (``layers.wqkv``, ...)."""
        from ..convert import _leaves
        return _leaves(self.param_specs())

    def init(self, seed=0):
        """Random weights from ``seed``: normal(0, 0.02) matrices, unit
        norm scales (the reference's ``init`` distribution)."""
        return init_weights(self, seed, _UNIT_SCALES)

    def allreduce_grads(self):
        """Sum every parameter's ``.grad`` over the ranks holding other
        tokens (``dp`` and ``sp``), in place, in one collective; a no-op
        without such ranks.  Call it after ``backward()`` and before the
        update."""
        if not self._batch_live:
            return
        params = [p for p in self.parameters() if p.grad is not None]
        if not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        flat = _coll.psum(flat, self.mesh, self._batch_live)
        off = 0
        for p in params:
            p.grad.copy_(flat[off:off + p.grad.numel()].view_as(p.grad))
            off += p.grad.numel()

    # -------------------------------------------------------------- forward
    def _layer_weights(self, li):
        """Layer ``li``'s slice of the stacked weights, by name."""
        return {n: getattr(self.layers, n)[li] for n in LAYER_NAMES}

    def _tp_in(self, h):
        """Megatron's "f" before a column-split matmul: the identity,
        whose backward sums the input's gradient over ``tp``."""
        if self._tp_live:
            return _coll.copy_to(h, self.mesh, (self._tp_live,))
        return h

    def _row_matmul(self, a, w):
        """``a @ w`` for a weight split on its rows over ``tp`` (Megatron's
        "g"): the f32 partial products summed over ``tp``; one rank's
        product is the plain matmul."""
        if self._tp_live:
            return _coll.psum(torch.matmul(a.float(), w.float()), self.mesh,
                              (self._tp_live,))
        return torch.matmul(a, w)

    def _qkv(self, x, lp):
        """ln1 + fused QKV projection: x [B,S,D] -> q,k,v [B,H,S,Dh] (H the
        rank's heads); ``lp`` is one layer's weights
        (:meth:`_layer_weights`)."""
        B, S, D = x.shape
        H, Dh = lp["wqkv"].shape[-2], self.cfg.head_dim
        h = self._tp_in(_norm(x, lp["ln1"]))
        w = lp["wqkv"].reshape(D, 3 * H * Dh)
        qkv = torch.matmul(h, w).to(x.dtype).view(B, S, 3, H, Dh)
        q = qkv[:, :, 0].transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        return q, k, v

    def _attn_mlp(self, x, o, lp):
        """Output projection + residual + MLP half of one layer; ``o`` is
        the attention output [B,H,S,Dh]."""
        B, H, S, Dh = o.shape
        wo = lp["wo"].reshape(H * Dh, -1)
        o = self._row_matmul(o.transpose(1, 2).reshape(B, S, H * Dh), wo)
        x = x + o.to(x.dtype)
        h = self._tp_in(_norm(x, lp["ln2"]))
        u = torch.matmul(h, lp["w1"])
        u = F.gelu(u.float(), approximate="tanh").to(x.dtype)
        d = self._row_matmul(u, lp["w2"]).to(x.dtype)
        return x + d

    def _attention(self, q, k, v):
        if self._sp_live:
            return ring_attention(q, k, v, axis_name=self._sp_live,
                                  causal=self.cfg.causal, mesh=self.mesh)
        return _kernels.attention(q, k, v, causal=self.cfg.causal)

    def _layer(self, x, lp):
        """One whole layer: attention (``cfg.causal``) and the MLP."""
        q, k, v = self._qkv(x, lp)
        return self._attn_mlp(x, self._attention(q, k, v), lp)

    def run_stack(self, x):
        """The shared encoder body: the layers through
        ``runtime.scan_stack`` (under the ``runtime.remat`` knob), then
        the final norm.  x [B, S, D] in the model dtype -> [B, S, D].
        Used by :meth:`apply` and :meth:`loss`, and by models that embed
        differently before the stack (``models.bert``)."""
        xs = {n: getattr(self.layers, n) for n in LAYER_NAMES}

        def body(carry, lp):
            return self._layer(carry, lp), None

        x, _ = _runtime.scan_stack(body, x, xs)
        return _norm(x, self.final_norm)

    def _embed(self, tokens, positions):
        return (self.embed[tokens] + self.pos_embed[positions]).to(
            self.cfg.dtype)

    def _as_index(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(_host(x).astype(_np.int64),
                               device=self.device)

    def _token_spec(self):
        """How a [B, S] token array splits: rows over ``dp``, positions
        over ``sp``."""
        return (self._dp, self._sp)

    def _local(self, x):
        """This rank's block of a global [B, S, ...] array."""
        if self.mesh is None:
            return x
        return _coll.local_block(x, self.mesh, self._token_spec())

    def _positions(self, S):
        """The global positions of this rank's S sequence positions."""
        start = self.mesh.axis_index(self._sp) * S if self._sp_live else 0
        return torch.arange(start, start + S, device=self.device)[None]

    def _logits(self, tokens):
        """The differentiable forward shared by :meth:`apply` and
        :meth:`loss`: tokens [B, S] int64 on the model's device (this
        rank's block) -> logits [B, S, V] (f32)."""
        x = self._embed(tokens, self._positions(tokens.shape[1]))
        x = self.run_stack(x)
        return torch.matmul(x.float(), self.embed.float().t())

    @torch.no_grad()
    def apply(self, tokens):
        """tokens [B, S] int -> logits [B, S, V] (f32), without autograd
        (the serving forward).  Over a mesh every rank passes the global
        tokens and gets the global logits."""
        logits = self._logits(self._local(self._as_index(tokens)))
        if self.mesh is None:
            return logits
        return _coll.unshard(logits, self.mesh, self._token_spec())

    forward = apply

    def loss(self, tokens, targets):
        """Mean next-token cross entropy over f32 logits, ``logsumexp -
        gold`` as the reference computes it; tokens and targets [B, S]
        int (the global arrays on every rank over a mesh).
        Differentiable: parameters get gradients once switched on
        (``model.requires_grad_(True)``; they are created without).  With
        ``dp`` or ``sp`` ranks, each rank's sum over its block is summed
        over them and divided by the global count."""
        tokens, targets = self._as_index(tokens), self._as_index(targets)
        logits = self._logits(self._local(tokens))
        targets = self._local(targets)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        if not self._batch_live:
            return (logz - gold).mean()
        total = _coll.psum((logz - gold).sum(), self.mesh, self._batch_live)
        return total / tokens.numel()

    def _rows(self, x):
        """This rank's rows (over ``dp``) of a global [B, ...] array."""
        if self.mesh is None:
            return x
        return _coll.local_block(x, self.mesh, (self._dp,))

    def _sample_rows(self, sample):
        """This rank's rows of the per-row sampling controls (host
        arrays)."""
        if sample is None or not _mesh_axis(self.mesh, "dp"):
            return sample
        n, i = self.mesh.shape["dp"], self.mesh.axis_index("dp")
        out = {}
        for name, v in sample.items():
            a = _host(v)
            b = a.shape[0] // n
            out[name] = a[i * b:(i + 1) * b]
        return out

    def _all_rows(self, x):
        """The global [B, ...] array from every ``dp`` rank's rows."""
        if self.mesh is None:
            return x
        return _coll.unshard(x, self.mesh, (self._dp,))

    def _whole_seq(self, x, dim):
        """``x`` gathered whole over ``sp`` along the sequence ``dim``."""
        if not self._sp_live:
            return x
        spec = [None] * x.dim()
        spec[dim] = self._sp_live
        return _coll.unshard(x, self.mesh, spec)

    # --------------------------------------------- generation (paged KV)
    def kv_spec(self, quantized=False):
        """Static description of the page pool (stamped into the export
        meta)."""
        cfg = self.cfg
        spec = {"num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                "head_dim": cfg.head_dim, "dtype": dtype_name(cfg.dtype)}
        if quantized:
            spec["quantized"] = True
        return spec

    def init_kv_pages(self, num_pages, page_size, quantized=False):
        """Zeroed page pool: {"k","v"} of [L, num_pages, page_size, H, Dh]
        in the model dtype; with ``quantized`` int8 payloads plus
        {"k_scale","v_scale"} of [L, num_pages, page_size, H] f32.  Over
        ``tp`` ranks H is this rank's heads."""
        cfg = self.cfg
        shape = (cfg.num_layers, int(num_pages), int(page_size),
                 self.layers.wqkv.shape[-2], cfg.head_dim)
        dev = self.device
        if quantized:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], device=dev),
                    "v_scale": torch.zeros(shape[:-1], device=dev)}
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}

    def _logits_last(self, x):
        """Final norm + tied-embedding readout: x [B, D] -> [B, V] f32."""
        x = _norm(x, self.final_norm)
        return torch.matmul(x.float(), self.embed.float().t())

    def _sample_last(self, x, positions, sample):
        """Readout + next-token choice for one position per row.

        ``sample`` None = greedy argmax.  Otherwise per-row controls
        ``temperature`` [B] (0 = greedy for that row), ``top_k`` [B]
        (0 = off), ``top_p`` [B] (1 = off) and ``key`` [B, 2] uint32 seed
        words.  The row's noise comes from ``self.gumbel`` folded with the
        position of the token being sampled.  Sampling is Gumbel-max over
        the temperature-scaled, top-k/top-p masked logits; temperature-0
        rows take the unscaled argmax.  Returns ``(ids [B] int64,
        logits [B, V] f32)``."""
        logits = self._logits_last(x)
        greedy = torch.argmax(logits, dim=-1)
        if sample is None:
            return greedy, logits
        temp_h = _host(sample["temperature"]).astype(_np.float32)
        if not (temp_h > 0).any():
            return greedy, logits
        dev = logits.device
        temp = torch.as_tensor(temp_h, device=dev)
        top_k = torch.as_tensor(_host(sample["top_k"]).astype(_np.int64),
                                device=dev)
        top_p = torch.as_tensor(_host(sample["top_p"]).astype(_np.float32),
                                device=dev)
        V = logits.shape[-1]
        safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
        scaled = logits / safe_t[:, None]
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        # top-k: the kth-largest scaled logit is the row threshold
        k_idx = torch.clamp(top_k - 1, 0, V - 1)
        kth = torch.gather(sorted_desc, 1, k_idx[:, None])
        keep = torch.where((top_k > 0)[:, None], scaled >= kth,
                           torch.ones_like(scaled, dtype=torch.bool))
        # top-p: token i survives while the mass BEFORE it is < p
        probs = torch.softmax(sorted_desc, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        in_nucleus = (csum - probs) < top_p[:, None]
        thr = torch.where(in_nucleus, sorted_desc,
                          torch.full_like(sorted_desc, math.inf)).amin(
                              dim=-1, keepdim=True)
        keep &= torch.where((top_p < 1.0)[:, None], scaled >= thr,
                            torch.ones_like(keep))
        masked = torch.where(keep, scaled,
                             torch.full_like(scaled, -math.inf))
        gum = self.gumbel(_host(sample["key"]), _host(positions), V, dev)
        choice = torch.argmax(masked + gum, dim=-1)
        return torch.where(temp > 0, choice, greedy), logits

    @torch.no_grad()
    def prefill(self, kv, tokens, lengths, page_table, page_size,
                sample=None, return_logits=False):
        """Process whole prompts and seed the paged cache (in place).

        tokens [B, S] (rows padded past ``lengths``), lengths [B],
        page_table [B, W] with W*page_size >= S.  Runs the causal stack —
        the attention seen by position ``lengths-1`` is ``apply()``'s —
        while each layer's K/V rows are written into the pool; positions
        past a prompt's length (and sentinel table entries) write nothing.
        An int8 pool quantises each row on the way in; prefill attention
        itself reads the full-precision stream.  Returns
        ``(kv, next_token [B])`` plus the next-token logits with
        ``return_logits``.  Over a mesh (module doc) S splits over
        ``sp``."""
        cfg = self.cfg
        tokens = self._rows(self._as_index(tokens))
        lengths = self._rows(self._as_index(lengths))
        table = self._rows(self._as_index(page_table))
        B, S = tokens.shape
        psz = int(page_size)
        pool = kv["k"].shape[1]
        quant = "k_scale" in kv
        dev = self.device
        block = tokens if not self._sp_live else _coll.local_block(
            tokens, self.mesh, (None, self._sp_live))
        x = self._embed(block, self._positions(block.shape[1]))
        iota = torch.arange(S, device=dev)
        pages = table[:, iota // psz]
        pages = torch.where(iota[None, :] < lengths[:, None], pages,
                            torch.full_like(pages, pool))
        slots = (iota % psz).expand(B, S)
        bi, si = ((pages >= 0) & (pages < pool)).nonzero(as_tuple=True)
        pw, sw = pages[bi, si], slots[bi, si]
        for li in range(cfg.num_layers):
            lp = self._layer_weights(li)
            q, k, v = self._qkv(x, lp)
            kt = self._whole_seq(k, 2).transpose(1, 2)[bi, si]  # [N, H, Dh]
            vt = self._whole_seq(v, 2).transpose(1, 2)[bi, si]
            if quant:
                kq, ks = quantize_rows(kt)
                vq, vs = quantize_rows(vt)
                kv["k"][li][pw, sw] = kq
                kv["v"][li][pw, sw] = vq
                kv["k_scale"][li][pw, sw] = ks
                kv["v_scale"][li][pw, sw] = vs
            else:
                kv["k"][li][pw, sw] = kt.to(kv["k"].dtype)
                kv["v"][li][pw, sw] = vt.to(kv["v"].dtype)
            x = self._attn_mlp(x, self._attention(q, k, v), lp)
        x = self._whole_seq(x, 1)
        last = x[torch.arange(B, device=dev), torch.clamp(lengths - 1, 0)]
        ids, logits = self._sample_last(last, lengths,
                                        self._sample_rows(sample))
        ids = self._all_rows(ids)
        if return_logits:
            return kv, ids, self._all_rows(logits)
        return kv, ids

    @torch.no_grad()
    def decode_step(self, kv, token_ids, positions, page_table, page_size,
                    sample=None, return_logits=False):
        """One generation iteration for a whole decode batch (pool updated
        in place).

        token_ids [B] (the token to append), positions [B] (its position =
        tokens already cached), page_table [B, W].  Appends each token's
        K/V to its page and attends over positions <= its own via
        ``kernels.paged_attention_pool``, which reads the context through
        the page table from the pool itself (tier off: gathers it and runs
        the plain version).  Inactive slots pass the sentinel everywhere:
        their write is dropped and their output is ignored by the
        scheduler.  With an int8 pool the appended row is quantised and the
        per-row scales are read beside the pages, dequantised in registers.
        Returns ``(kv, next_token [B])`` (+ logits with ``return_logits``).
        Over a mesh: module doc."""
        cfg = self.cfg
        token_ids = self._rows(self._as_index(token_ids))
        positions = self._rows(self._as_index(positions))
        pos_h = _host(positions)
        table = self._rows(self._as_index(page_table))
        psz = int(page_size)
        pool = kv["k"].shape[1]
        quant = "k_scale" in kv
        x = self._embed(token_ids, positions)[:, None]          # [B,1,D]
        page = torch.gather(table, 1, (positions // psz)[:, None])[:, 0]
        slot = positions % psz
        (wb,) = ((page >= 0) & (page < pool)).nonzero(as_tuple=True)
        pw, sw = page[wb], slot[wb]
        table32 = table.to(torch.int32)
        lengths = (positions + 1).to(torch.int32)
        for li in range(cfg.num_layers):
            lp = self._layer_weights(li)
            q, k, v = self._qkv(x, lp)                           # [B,H,1,Dh]
            kt, vt = k[wb, :, 0], v[wb, :, 0]                    # [N,H,Dh]
            kl, vl = kv["k"][li], kv["v"][li]
            scales = {}
            if quant:
                kq, ks = quantize_rows(kt)
                vq, vs = quantize_rows(vt)
                kl[pw, sw] = kq
                vl[pw, sw] = vq
                ksl, vsl = kv["k_scale"][li], kv["v_scale"][li]
                ksl[pw, sw] = ks
                vsl[pw, sw] = vs
                scales = {"k_scale_pool": ksl, "v_scale_pool": vsl}
            else:
                kl[pw, sw] = kt.to(kl.dtype)
                vl[pw, sw] = vt.to(vl.dtype)
            o = _kernels.paged_attention_pool(q, kl, vl, table32, lengths,
                                              **scales)
            x = self._attn_mlp(x, o, lp)
        ids, logits = self._sample_last(x[:, 0], pos_h + 1,
                                        self._sample_rows(sample))
        ids = self._all_rows(ids)
        if return_logits:
            return kv, ids, self._all_rows(logits)
        return kv, ids

    @torch.no_grad()
    def greedy_decode(self, prompt, max_new_tokens, eos_id=None):
        """Cache-free greedy-decode reference: a full re-forward of the
        whole sequence per token (slow by design; the oracle the paged
        path is held against).  Returns the generated ids (eos included
        when hit) as np.int32."""
        toks = [int(t) for t in _np.asarray(prompt).reshape(-1)]
        if len(toks) + int(max_new_tokens) > self.cfg.max_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_len %d"
                % (len(toks), max_new_tokens, self.cfg.max_len))
        out = []
        for _ in range(int(max_new_tokens)):
            logits = self.apply(_np.asarray([toks], _np.int64))
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks.append(nxt)
            if eos_id is not None and nxt == int(eos_id):
                break
        return _np.asarray(out, _np.int32)
