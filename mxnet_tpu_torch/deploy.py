"""Generation artifacts (counterpart of ``mxnet_tpu.deploy``
``export_generation`` / ``GenerationPredictor``).

The reference serialises StableHLO programs, which PyTorch cannot load,
so the port has its own format: ``<prefix>-meta.json`` (the reference's
meta fields plus the model configuration) and ``<prefix>-params.pt``
(the weights as a tensor state dict).  The two packages are held
against each other on OUTPUTS, never on artifacts.

The reference exports one prefill program per prompt bucket and one
decode program per page-table width.  The port runs eagerly, but keeps
the same families: every prefill is padded to a prompt bucket and every
decode step to a width, so the set of shapes a server ever runs stays
bounded (one CUDA graph per shape is later work).
"""
from __future__ import annotations

import json
import math as _math
import os

import numpy as _np
import torch

from . import config as _config
from .models.transformer import TransformerLM, TransformerLMConfig

__all__ = ["export_generation", "GenerationPredictor", "load_generator",
           "FORMAT", "FORMAT_VERSION"]

FORMAT = "mxnet_tpu_torch.generation"
FORMAT_VERSION = 1
_KV_KEYS = ("k", "v")
_KV_KEYS_QUANT = ("k", "v", "k_scale", "v_scale")


def _pow2_family(cap):
    """Powers of two up to (and always including) ``cap``."""
    sizes, b = [], 1
    while b < cap:
        sizes.append(b)
        b *= 2
    sizes.append(int(cap))
    return tuple(sizes)


def pick_bucket(buckets, n):
    """Smallest bucket that fits ``n``, or None."""
    return next((b for b in buckets if b >= n), None)


def _paged_route(spec, width, page_size, batch, quantized):
    """Kernel-route verdict for one decode width on the card with the tier
    on: the pool-form paged kernel's own feasibility check on ``meta``
    tensors of the width's decode shapes (``decode_step`` reads the pool
    through the page table).  ``"unsupported"`` means such a decode call
    on CUDA tensors raises (the tier off serves it)."""
    from .ops.cuda_kernels import paged_pool_unsupported_reason
    from .models.transformer import _dtype
    B, H, D = batch, spec["num_heads"], spec["head_dim"]
    dt = _dtype(spec["dtype"])
    pool = torch.empty(1, page_size, H, D,
                       dtype=torch.int8 if quantized else dt, device="meta")
    q = torch.empty(B, H, 1, D, dtype=dt, device="meta")
    table = torch.empty(B, width, dtype=torch.int32, device="meta")
    lengths = torch.empty(B, dtype=torch.int32, device="meta")
    scale = (torch.empty(1, page_size, H, dtype=torch.float32,
                         device="meta") if quantized else None)
    reason = paged_pool_unsupported_reason(q, pool, pool, table, lengths,
                                           scale, scale)
    return {"impl": "unsupported" if reason else "paged", "reason": reason,
            "quantized": bool(quantized)}


def export_generation(model, params, prefix, page_size=None,
                      max_context=None, prompt_buckets=None,
                      include_params=True, sampling=False,
                      kv_quantized=False, decode_batch=None):
    """Write a generation artifact for ``model`` (a
    :class:`~mxnet_tpu_torch.models.transformer.TransformerLM`).

    ``params`` is the reference-layout weight tree (numpy or tensors), or
    None for the model's own weights.  ``page_size`` defaults to the
    ``serving.kv_page_size`` knob; ``max_context`` (default
    ``cfg.max_len``) bounds prompt + generated tokens and sizes the
    decode-width family (pow2 over ``ceil(max_context / page_size)``
    pages); ``prompt_buckets`` defaults to the pow2 family over
    ``max_context`` from 8 up.  ``sampling`` enables per-request
    temperature / top-k / top-p; ``kv_quantized`` makes the page pool int8
    with per-row f32 scales; ``decode_batch`` pins the decode batch.
    ``meta["paged"]`` holds the per-width kernel-route verdict.  Returns
    the written paths."""
    cfg = model.cfg
    psz = int(page_size if page_size is not None
              else _config.get("serving.kv_page_size"))
    if psz < 1:
        raise ValueError("page_size must be >= 1, got %d" % psz)
    max_context = int(max_context if max_context is not None
                      else cfg.max_len)
    if max_context > cfg.max_len:
        raise ValueError(
            "max_context %d exceeds the model's positional table (%d)"
            % (max_context, cfg.max_len))
    if prompt_buckets is None:
        fam = _pow2_family(max_context)
        prompt_buckets = tuple(s for s in fam if s >= min(8, max_context))
    prompt_buckets = tuple(sorted(int(s) for s in prompt_buckets))
    if not prompt_buckets or prompt_buckets[-1] > max_context:
        raise ValueError(
            "prompt_buckets %r must be non-empty and fit max_context %d"
            % (prompt_buckets, max_context))
    widths = _pow2_family(_math.ceil(max_context / psz))
    if decode_batch is not None:
        decode_batch = int(decode_batch)
        if decode_batch < 1:
            raise ValueError("decode_batch must be >= 1, got %d"
                             % decode_batch)
    if params is None:
        state = {n: p.detach().cpu() for n, p in model.state_dict().items()}
    else:
        from .convert import params_from_reference
        state = params_from_reference(params)
    spec = model.kv_spec(quantized=kv_quantized)
    batch = decode_batch or _config.get("serving.decode_slots")
    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "param_names": sorted(state),
        "input_dtype": "int32",
        "generate": True,
        "model": cfg.to_dict(),
        "vocab_size": int(cfg.vocab_size),
        "max_context": max_context,
        "prompt_buckets": list(prompt_buckets),
        "decode_widths": list(widths),
        "kv": dict(spec, page_size=psz),
        "paged": {str(w): _paged_route(spec, w, psz, batch, kv_quantized)
                  for w in widths},
        "sampling": bool(sampling),
    }
    if decode_batch is not None:
        meta["decode_batch"] = decode_batch
    paths = []
    meta_path = prefix + "-meta.json"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    paths.append(meta_path)
    if include_params:
        params_path = prefix + "-params.pt"
        torch.save(state, params_path)
        paths.append(params_path)
    return paths


class GenerationPredictor:
    """A reloaded generation artifact: the model on its device plus the
    prompt-bucket and decode-width families.

    ``mxnet_tpu_torch.generation.GenerationEngine`` drives
    :meth:`prefill_fn` / :meth:`decode_fn` per iteration;
    :meth:`generate` is the offline single-sequence loop."""

    def __init__(self, prefix, device=None):
        with open(prefix + "-meta.json") as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError("artifact %r is not a %s artifact (format %r)"
                             % (prefix, FORMAT, self.meta.get("format")))
        self.format_version = int(self.meta["format_version"])
        if self.format_version > FORMAT_VERSION:
            raise ValueError(
                "artifact %r is format v%d, newer than this build's v%d"
                % (prefix, self.format_version, FORMAT_VERSION))
        if not self.meta.get("generate", False):
            raise ValueError("artifact %r carries no generation programs"
                             % (prefix,))
        self.page_size = int(self.meta["kv"]["page_size"])
        self.max_context = int(self.meta["max_context"])
        self.prompt_buckets = tuple(self.meta["prompt_buckets"])
        self.decode_widths = tuple(self.meta["decode_widths"])
        self.kv_dtype = self.meta["kv"]["dtype"]
        self.sampling = bool(self.meta.get("sampling", False))
        self.kv_quantized = bool(self.meta["kv"].get("quantized", False))
        db = self.meta.get("decode_batch")
        self.decode_batch = int(db) if db is not None else None
        #: per-width kernel-route verdict recorded at export
        self.paged_routes = dict(self.meta.get("paged", {}))
        self.model = TransformerLM(TransformerLMConfig(**self.meta["model"]),
                                   device=device)
        self.device = self.model.device
        params_path = prefix + "-params.pt"
        self.has_params = os.path.exists(params_path)
        if self.has_params:
            state = torch.load(params_path, map_location=self.device,
                               weights_only=True)
            self.model.load_state_dict(state)

    # shape families -------------------------------------------------
    def prefill_bucket(self, prompt_len):
        """Smallest exported prompt bucket that fits, or a clear error."""
        s_bucket = pick_bucket(self.prompt_buckets, prompt_len)
        if s_bucket is None:
            raise ValueError(
                "prompt of %d tokens exceeds the largest exported "
                "prefill bucket (%d); re-export with bigger "
                "prompt_buckets" % (prompt_len, self.prompt_buckets[-1]))
        return s_bucket

    def decode_width(self, pages_needed):
        width = pick_bucket(self.decode_widths, pages_needed)
        if width is None:
            raise ValueError(
                "sequence needs %d KV pages, more than the largest "
                "exported page-table width (%d)"
                % (pages_needed, self.decode_widths[-1]))
        return width

    def _sample(self, temp, tk, tp, keys):
        if not self.sampling:
            return None   # greedy-only artifact ignores the controls
        return {"temperature": temp, "top_k": tk, "top_p": tp, "key": keys}

    def prefill_fn(self, s_bucket):
        """``fn(kv, tokens, lengths, table, temp, top_k, top_p, keys) ->
        (kv, next_ids)`` for one prompt bucket; ``tokens`` must be
        ``[B, s_bucket]`` and ``table`` ``[B, ceil(s_bucket/page)]``."""
        if s_bucket not in self.prompt_buckets:
            raise ValueError("%d is not an exported prompt bucket %r"
                             % (s_bucket, self.prompt_buckets))
        w_s = _math.ceil(s_bucket / self.page_size)

        def fn(kv, tokens, lengths, table, temp, tk, tp, keys):
            tokens, table = _np.asarray(tokens), _np.asarray(table)
            if tokens.shape[1] != s_bucket or table.shape[1] != w_s:
                raise ValueError(
                    "prefill bucket %d takes tokens [B, %d] and table "
                    "[B, %d], got %s and %s" % (s_bucket, s_bucket, w_s,
                                                tokens.shape, table.shape))
            return self.model.prefill(dict(zip(self._kv_keys, kv)), tokens,
                                      lengths, table, self.page_size,
                                      sample=self._sample(temp, tk, tp,
                                                          keys))
        return self._wrap(fn)

    def decode_fn(self, width):
        """``fn(kv, token_ids, positions, table, temp, top_k, top_p, keys)
        -> (kv, next_ids)`` for one page-table width."""
        if width not in self.decode_widths:
            raise ValueError("%d is not an exported decode width %r"
                             % (width, self.decode_widths))

        def fn(kv, token_ids, positions, table, temp, tk, tp, keys):
            table = _np.asarray(table)
            if table.shape[1] != width:
                raise ValueError("decode width %d takes table [B, %d], got "
                                 "%s" % (width, width, table.shape))
            return self.model.decode_step(dict(zip(self._kv_keys, kv)),
                                          token_ids, positions, table,
                                          self.page_size,
                                          sample=self._sample(temp, tk, tp,
                                                              keys))
        return self._wrap(fn)

    @property
    def _kv_keys(self):
        return _KV_KEYS_QUANT if self.kv_quantized else _KV_KEYS

    def _wrap(self, fn):
        keys = self._kv_keys

        def call(kv, *args):
            nkv, ids = fn(kv, *args)
            return tuple(nkv[k] for k in keys), ids
        return call

    def make_kv(self, num_pages):
        """Zeroed page pool tuple for this artifact: ``(k, v)`` or, with
        int8 KV, ``(k, v, k_scale, v_scale)``; updated in place by every
        prefill/decode call."""
        kv = self.model.init_kv_pages(num_pages, self.page_size,
                                      quantized=self.kv_quantized)
        return tuple(kv[k] for k in self._kv_keys)

    def sample_arrays(self, temperature, top_k, top_p, seeds):
        """Per-row sampling operands: (temp f32, top_k i32, top_p f32,
        keys uint32[B, 2]); a 64-bit seed splits into two key words."""
        temp = _np.asarray(temperature, _np.float32).reshape(-1)
        B = temp.shape[0]
        keys = _np.zeros((B, 2), _np.uint32)
        s = _np.asarray(seeds, _np.uint64).reshape(-1)
        keys[:, 0] = (s >> _np.uint64(32)).astype(_np.uint32)
        keys[:, 1] = (s & _np.uint64(0xFFFFFFFF)).astype(_np.uint32)
        return (temp, _np.asarray(top_k, _np.int32).reshape(-1),
                _np.asarray(top_p, _np.float32).reshape(-1), keys)

    def generate(self, prompt, max_new_tokens, eos_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=0):
        """Decode ONE sequence through the bucketed prefill and the
        width-bucketed decode steps over a private page pool.  Returns the
        generated ids (eos included when hit) as np.int32."""
        if not self.has_params:
            raise ValueError("artifact was exported with "
                             "include_params=False")
        temperature = float(temperature)
        if temperature > 0 and not self.sampling:
            raise ValueError("temperature=%g needs an artifact exported "
                             "with sampling=True" % temperature)
        prompt = _np.asarray(prompt, _np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        max_new = int(max_new_tokens)
        if plen < 1 or max_new < 1:
            raise ValueError("need a non-empty prompt and "
                             "max_new_tokens >= 1")
        if plen + max_new > self.max_context:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_context %d"
                % (plen, max_new, self.max_context))
        psz = self.page_size
        need = _math.ceil((plen + max_new) / psz)
        kv = self.make_kv(need)
        pages = _np.arange(need, dtype=_np.int32)
        sentinel = need
        s_bucket = self.prefill_bucket(plen)
        w_s = _math.ceil(s_bucket / psz)
        tokens = _np.zeros((1, s_bucket), _np.int32)
        tokens[0, :plen] = prompt
        table = _np.full((1, w_s), sentinel, _np.int32)
        table[0, :min(w_s, need)] = pages[:w_s]
        samp1 = self.sample_arrays([temperature], [top_k], [top_p],
                                   [int(seed)])
        kv, nxt = self.prefill_fn(s_bucket)(
            kv, tokens, _np.asarray([plen], _np.int32), table, *samp1)
        out = [int(nxt[0])]
        pos = plen
        Bd = self.decode_batch or 1
        sampB = self.sample_arrays(
            [temperature] + [0.0] * (Bd - 1), [int(top_k)] + [0] * (Bd - 1),
            [float(top_p)] + [1.0] * (Bd - 1), [int(seed)] + [0] * (Bd - 1))
        while len(out) < max_new and (eos_id is None
                                      or out[-1] != int(eos_id)):
            width = self.decode_width(pos // psz + 1)
            table = _np.full((Bd, width), sentinel, _np.int32)
            table[0, :min(width, need)] = pages[:width]
            toks = _np.zeros((Bd,), _np.int32)
            toks[0] = out[-1]
            poss = _np.zeros((Bd,), _np.int32)
            poss[0] = pos
            kv, nxt = self.decode_fn(width)(kv, toks, poss, table, *sampB)
            out.append(int(nxt[0]))
            pos += 1
        return _np.asarray(out, _np.int32)


def load_generator(prefix, device=None):
    """Reload a generation artifact onto ``device`` (default ``cuda:0``)."""
    return GenerationPredictor(prefix, device=device)
