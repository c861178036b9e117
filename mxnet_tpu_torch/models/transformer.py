"""TransformerLM — decoder-only language model with paged-KV generation
(counterpart of ``mxnet_tpu.models.transformer``).

An ``nn.Module`` that owns its weights, in the reference's stacked
parameter layout (``wqkv [L, D, 3, H, Dh]``, ``wo [L, H, Dh, D]``,
``w1 [L, D, F]``, ``w2 [L, F, D]``, ``ln1``/``ln2 [L, D]``, ``embed
[V, D]``, ``pos_embed [max_len, D]``, ``final_norm [D]``), so
``convert.params_from_reference`` carries the reference's weights across
unchanged.  The reference's ``lax.scan`` over layers is a Python loop.

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
from ..context import resolve_device
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


class _Layers(nn.Module):
    """The per-layer weights, stacked over layers (reference layout)."""

    def __init__(self, cfg, device):
        super().__init__()
        L, D, F_, H, Dh = (cfg.num_layers, cfg.d_model, cfg.d_ff,
                           cfg.num_heads, cfg.head_dim)

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


class TransformerLM(nn.Module):
    """Decoder-only transformer over stacked layer weights.

    ``device`` defaults to ``cuda:0`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  ``self.gumbel`` is the sampler's
    noise source (:func:`gumbel_noise`); tests replace it to feed both
    packages identical noise."""

    def __init__(self, config, device=None):
        super().__init__()
        self.cfg = config
        dev = resolve_device(device)
        V, D, S = config.vocab_size, config.d_model, config.max_len

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=config.dtype,
                                            device=dev),
                                requires_grad=False)

        self.embed = p(V, D)
        self.pos_embed = p(S, D)
        self.final_norm = p(D)
        self.layers = _Layers(config, dev)
        self.gumbel = gumbel_noise

    @property
    def device(self):
        return self.embed.device

    # -------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, seed=0):
        """Random weights from ``seed``: normal(0, 0.02) matrices, unit
        norm scales (the reference's ``init`` distribution)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for name, prm in self.named_parameters():
            if name.endswith(("ln1", "ln2", "final_norm")):
                prm.fill_(1.0)
            else:
                prm.copy_(torch.randn(prm.shape, generator=g,
                                      device=self.device,
                                      dtype=torch.float32) * 0.02)
        return self

    # -------------------------------------------------------------- forward
    def _qkv(self, x, li):
        """ln1 + fused QKV projection: x [B,S,D] -> q,k,v [B,H,S,Dh]."""
        B, S, D = x.shape
        H, Dh = self.cfg.num_heads, self.cfg.head_dim
        h = _norm(x, self.layers.ln1[li])
        w = self.layers.wqkv[li].reshape(D, 3 * H * Dh)
        qkv = torch.matmul(h, w).to(x.dtype).view(B, S, 3, H, Dh)
        q = qkv[:, :, 0].transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        return q, k, v

    def _attn_mlp(self, x, o, li):
        """Output projection + residual + MLP half of one layer; ``o`` is
        the attention output [B,H,S,Dh]."""
        B, H, S, Dh = o.shape
        wo = self.layers.wo[li].reshape(H * Dh, -1)
        o = torch.matmul(o.transpose(1, 2).reshape(B, S, H * Dh), wo)
        x = x + o.to(x.dtype)
        h = _norm(x, self.layers.ln2[li])
        u = torch.matmul(h, self.layers.w1[li])
        u = F.gelu(u.float(), approximate="tanh").to(x.dtype)
        d = torch.matmul(u, self.layers.w2[li]).to(x.dtype)
        return x + d

    def _embed(self, tokens, positions):
        return (self.embed[tokens] + self.pos_embed[positions]).to(
            self.cfg.dtype)

    def _as_index(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(_host(x).astype(_np.int64),
                               device=self.device)

    def _logits(self, tokens):
        """The differentiable forward shared by :meth:`apply` and
        :meth:`loss`: tokens [B, S] int64 on the model's device -> logits
        [B, S, V] (f32)."""
        S = tokens.shape[1]
        x = self._embed(tokens, torch.arange(S, device=self.device)[None])
        for li in range(self.cfg.num_layers):
            q, k, v = self._qkv(x, li)
            o = _kernels.attention(q, k, v, causal=self.cfg.causal)
            x = self._attn_mlp(x, o, li)
        x = _norm(x, self.final_norm)
        return torch.matmul(x.float(), self.embed.float().t())

    @torch.no_grad()
    def apply(self, tokens):
        """tokens [B, S] int -> logits [B, S, V] (f32), without autograd
        (the serving forward)."""
        return self._logits(self._as_index(tokens))

    forward = apply

    def loss(self, tokens, targets):
        """Mean next-token cross entropy over f32 logits, ``logsumexp -
        gold`` as the reference computes it; tokens and targets [B, S]
        int.  Differentiable: parameters get gradients once switched on
        (``model.requires_grad_(True)``; they are created without)."""
        logits = self._logits(self._as_index(tokens))
        targets = self._as_index(targets)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (logz - gold).mean()

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
        {"k_scale","v_scale"} of [L, num_pages, page_size, H] f32."""
        cfg = self.cfg
        shape = (cfg.num_layers, int(num_pages), int(page_size),
                 cfg.num_heads, cfg.head_dim)
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
        ``return_logits``."""
        cfg = self.cfg
        tokens = self._as_index(tokens)
        lengths = self._as_index(lengths)
        table = self._as_index(page_table)
        B, S = tokens.shape
        psz = int(page_size)
        pool = kv["k"].shape[1]
        quant = "k_scale" in kv
        dev = self.device
        x = self._embed(tokens, torch.arange(S, device=dev)[None])
        iota = torch.arange(S, device=dev)
        pages = table[:, iota // psz]
        pages = torch.where(iota[None, :] < lengths[:, None], pages,
                            torch.full_like(pages, pool))
        slots = (iota % psz).expand(B, S)
        bi, si = ((pages >= 0) & (pages < pool)).nonzero(as_tuple=True)
        pw, sw = pages[bi, si], slots[bi, si]
        for li in range(cfg.num_layers):
            q, k, v = self._qkv(x, li)
            kt = k.transpose(1, 2)[bi, si]        # [N, H, Dh]
            vt = v.transpose(1, 2)[bi, si]
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
            o = _kernels.attention(q, k, v, causal=cfg.causal)
            x = self._attn_mlp(x, o, li)
        last = x[torch.arange(B, device=dev), torch.clamp(lengths - 1, 0)]
        ids, logits = self._sample_last(last, lengths, sample)
        if return_logits:
            return kv, ids, logits
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
        Returns ``(kv, next_token [B])`` (+ logits with ``return_logits``)."""
        cfg = self.cfg
        token_ids = self._as_index(token_ids)
        pos_h = _host(positions)
        positions = self._as_index(pos_h)
        table = self._as_index(page_table)
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
            q, k, v = self._qkv(x, li)                           # [B,H,1,Dh]
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
            x = self._attn_mlp(x, o, li)
        ids, logits = self._sample_last(x[:, 0], pos_h + 1, sample)
        if return_logits:
            return kv, ids, logits
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
