"""``mx.deploy`` — one-shot and generation artifacts (counterpart of
``mxnet_tpu.deploy``).

The reference serialises StableHLO programs, which PyTorch cannot load,
so the port writes its own program beside the reference's meta fields.
The two packages are held against each other on OUTPUTS; a reference
artifact's params and meta carry across with
``convert.oneshot_from_reference``.

One-shot artifacts (``export_model``, ``quantization.export_quantized``):

  {prefix}-symbol.json   the Block's graph, traced through its Symbol
                         forward (the port's ``HybridBlock.export``
                         schema); reloads with no Python class
  {prefix}-params.npz    parameter arrays by ``meta["param_names"]``
  {prefix}-meta.json     the reference's fields (``param_names``, input
                         and output shape and dtype, ``dynamic_batch``,
                         ``format_version``) plus ``program`` and
                         ``input_name``

Format versions, as the reference's: v1 fixed batch (no output fields),
v2 adds the output signature and ``dynamic_batch`` (any batch runs; a
graph whose shape inference fixes the batch records ``false``), v3 is
int8 (``quantized: true``, int8 weight payloads with ``<name>::scale``
companions, ``calibration``, ``measured_error``, ``excluded``) and
refuses the f32 load path.  The predictor keeps the reference's public
name, :class:`StableHLOPredictor`, though its program is the port's
graph.

Generation artifacts (``export_generation``): ``<prefix>-meta.json`` (the
reference's meta fields plus the model configuration, ``format``
``mxnet_tpu_torch.generation``) and ``<prefix>-params.pt`` (the weights
as a tensor state dict).  The reference exports one prefill program per
prompt bucket and one decode program per page-table width; the port runs
eagerly but keeps the same families, so the set of shapes a server runs
stays bounded.
"""
from __future__ import annotations

import json
import math as _math
import os

import numpy as _np
import torch

from . import config as _config
from .models.transformer import TransformerLM, TransformerLMConfig

__all__ = ["export_model", "load_model", "StableHLOPredictor",
           "export_generation", "GenerationPredictor", "load_generator",
           "FORMAT", "FORMAT_VERSION", "QUANTIZED_FORMAT_VERSION",
           "GENERATE_FORMAT_VERSION"]

#: one-shot f32 artifacts (``export_model``)
FORMAT_VERSION = 2
#: one-shot int8 artifacts (``quantization.export_quantized``)
QUANTIZED_FORMAT_VERSION = 3
#: newest one-shot format this build loads
MAX_SUPPORTED_FORMAT = 3
#: ``meta["program"]`` of the port's one-shot artifacts
ONESHOT_PROGRAM = "mxnet_tpu_torch.symbol"

#: generation artifacts: their own format string and version
FORMAT = "mxnet_tpu_torch.generation"
GENERATE_FORMAT_VERSION = 1
_KV_KEYS = ("k", "v")
_KV_KEYS_QUANT = ("k", "v", "k_scale", "v_scale")


# ---------------------------------------------------------------- one-shot

def _shape_signature(shape, dynamic=False):
    """JSON-safe shape; a dynamic batch dim becomes None."""
    return [None if dynamic and i == 0 else int(d)
            for i, d in enumerate(shape)]


def _flatten_params(tree, prefix=""):
    """Nested param dict -> sorted ``[("a/b/c", leaf)]``."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = prefix + str(k)
        if isinstance(v, dict):
            out.extend(_flatten_params(v, key + "/"))
        else:
            out.append((key, v))
    return out


def _unflatten_params(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host_array(x):
    from .ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _trace(block, input_name="data"):
    """The Block's graph: its forward on a Symbol variable."""
    from . import symbol as _sym
    try:
        out = block(_sym.var(input_name))
    except Exception as exc:  # noqa: BLE001 — say which Block and why
        raise ValueError(
            "export: %s's forward does not trace to a Symbol graph (%s: "
            "%s); the one-shot artifact needs a HybridBlock-style forward"
            % (type(block).__name__, type(exc).__name__, exc)) from exc
    if isinstance(out, (list, tuple)):
        if len(out) != 1:
            raise ValueError("export: one-shot artifacts take one output, "
                             "got %d" % len(out))
        out = out[0]
    return out, input_name


def _batch_free(graph, input_name, in_shape, out_shape):
    """Whether the graph runs at another batch: its shape inference at a
    second batch size gives that batch and the same trailing dims."""
    b2 = int(in_shape[0]) + 1
    try:
        _, outs, _ = graph.infer_shape(
            **{input_name: (b2,) + tuple(in_shape[1:])})
    except Exception:  # noqa: BLE001 — the graph fixes its batch
        return False
    if len(outs) != 1 or outs[0] is None:
        return False
    return tuple(outs[0]) == (b2,) + tuple(out_shape[1:])


def _oneshot_meta(input_name, data, out, dynamic, version):
    return {
        "program": ONESHOT_PROGRAM,
        "input_name": input_name,
        "input_shape": [int(d) for d in data.shape],
        "input_dtype": str(data.dtype),
        "output_shape": _shape_signature(out.shape, dynamic),
        "output_dtype": str(out.dtype),
        "dynamic_batch": bool(dynamic),
        "format_version": version,
    }


def _write_oneshot(prefix, graph, meta, arrays):
    """Write the graph, the meta and (when ``arrays`` is not None) the
    params; returns the paths."""
    paths = [prefix + "-symbol.json", prefix + "-meta.json"]
    graph.save(paths[0])
    with open(paths[1], "w") as f:
        json.dump(meta, f)
    if arrays is not None:
        paths.append(prefix + "-params.npz")
        _np.savez(paths[2], **{n: _np.asarray(arrays[n])
                               for n in meta["param_names"]})
    return paths


def export_model(block, prefix, example_input, include_params=True,
                 dynamic_batch=True):
    """Write a one-shot artifact of a Gluon Block's inference function.

    One eager forward of ``example_input`` resolves the deferred shapes
    and gives the output signature; the graph is the Block's Symbol
    forward.  With ``dynamic_batch`` (default) the artifact takes any
    batch size when the graph's shape inference allows it, else it
    records ``meta["dynamic_batch"] = false`` and serves the example's
    batch only.  Returns the written paths."""
    from .parallel.functional import functionalize
    from .quantization import _block_device, _forward, _host
    data = _host_array(example_input)
    out = _host(_forward(block, data, _block_device(block)))
    fn = functionalize(block)
    arrays = {n: v.detach().cpu().numpy()
              for n, v in fn.init_values().items()}
    graph, input_name = _trace(block)
    dynamic = bool(dynamic_batch) and data.ndim >= 1 and _batch_free(
        graph, input_name, data.shape, out.shape)
    meta = _oneshot_meta(input_name, data, out, dynamic, FORMAT_VERSION)
    meta["param_names"] = list(fn.params)
    return _write_oneshot(prefix, graph, meta,
                          arrays if include_params else None)


class StableHLOPredictor:
    """A reloaded one-shot artifact (the reference's predictor, under its
    public name so code written against it runs; the port's program is
    its own graph, not StableHLO).

    Parameters go to ``device`` once, at construction (default
    ``cuda:0``; ``"cpu"`` / ``mx.cpu()`` on request) and every
    :meth:`predict` reuses them.  ``quantized=True`` is required for a v3
    int8 artifact and refused for an f32 one; the int8 sites are
    recolored once, here: each runs ``ops.int8`` at its calibrated scale,
    never f32.

    On the CPU, PyTorch's GEMM and convolution choose their kernels by
    batch size, so a row's bits would depend on the rows beside it; the
    CPU program runs a row at a time, so a served row is bitwise its own
    batch-1 :meth:`predict` (the reference's batching promise).  On the
    card the batch runs whole."""

    def __init__(self, prefix, quantized=False, device=None):
        from .context import resolve_device
        from . import symbol as _sym
        with open(prefix + "-meta.json") as f:
            self.meta = json.load(f)
        self.format_version = int(self.meta.get("format_version", 1))
        if self.meta.get("generate", False):
            raise ValueError(
                "artifact %r is a GENERATION export: it carries a model "
                "for prefill + decode over a paged KV cache, not a "
                "one-shot predict program. Load it with "
                "deploy.load_generator(prefix) or "
                "serving.Server.register(..., generate=True)." % (prefix,))
        if self.format_version > MAX_SUPPORTED_FORMAT:
            raise ValueError(
                "artifact %r is deploy format v%d, newer than this "
                "build's v%d — upgrade before loading"
                % (prefix, self.format_version, MAX_SUPPORTED_FORMAT))
        if self.meta.get("program") != ONESHOT_PROGRAM:
            raise ValueError(
                "artifact %r carries no %s program (a reference StableHLO "
                "export?); carry it across with "
                "convert.oneshot_from_reference(block, prefix, out_prefix)"
                % (prefix, ONESHOT_PROGRAM))
        self.quantized = bool(self.meta.get("quantized", False))
        if self.quantized and not quantized:
            raise ValueError(
                "artifact %r is a QUANTIZED (format v%d) program: its "
                "params are int8 payloads and its outputs carry int8 "
                "numerics — the fp32 load path refuses it rather than "
                "silently dequantizing. Load it explicitly with "
                "deploy.load_model(prefix, quantized=True) or "
                "serving.Server.register(..., quantized=True)."
                % (prefix, self.format_version))
        if quantized and not self.quantized:
            raise ValueError(
                "artifact %r was loaded with quantized=True but is a "
                "plain fp32 export (format v%d, no quantized params); "
                "export it with mx.quantization.export_quantized or drop "
                "the flag" % (prefix, self.format_version))
        self.dynamic_batch = bool(self.meta.get("dynamic_batch", False))
        self.device = resolve_device(device)
        self._graph = _sym.load(prefix + "-symbol.json")
        self._input = self.meta.get("input_name", "data")
        self._params = None
        params_path = prefix + "-params.npz"
        if os.path.exists(params_path):
            with _np.load(params_path) as loaded:
                self._params = self._stage(
                    {n: loaded[n] for n in self.meta["param_names"]})
        if len(self._graph._heads()) != 1:
            raise ValueError("artifact %r: a one-shot program has one "
                             "output" % (prefix,))
        self._sites = {}
        if self.quantized and self._params is not None:
            from .quantization import recolor_sites
            self._sites = recolor_sites(self._graph, self._params,
                                        self.meta)

    def _stage(self, arrays):
        """Host arrays -> the program's tensors on the device, once; a
        quantized weight becomes its dequantized view ``q * scale`` (the
        int8 sites re-derive the shipped grid from it)."""
        from . import io as _io
        from .quantization import SCALE_SUFFIX
        out = {}
        for n, a in arrays.items():
            if n.endswith(SCALE_SUFFIX):
                continue
            out[n] = _io.ensure_staged(_np.ascontiguousarray(a),
                                       self.device, source="deploy")
        for n in self.meta.get("quantized_params") or ():
            scale = torch.as_tensor(arrays[n + SCALE_SUFFIX]).to(
                self.device)
            out[n] = out[n].to(torch.float32) * scale
        return out

    @property
    def recolored_sites(self):
        """The site names that run int8 (a v3 artifact), in order."""
        return [s.name for s in self._sites.values()]

    def _validate_input(self, x):
        """Shape / dtype against the exported signature: a clear
        ValueError instead of an op's shape error."""
        want_shape = self.meta.get("input_shape")
        want_dtype = self.meta.get("input_dtype")
        if want_shape is None:
            return
        got = tuple(int(s) for s in x.shape)
        want = tuple(want_shape)
        if len(got) != len(want):
            raise ValueError(
                "input rank mismatch: exported signature is %s (%d dims), "
                "got shape %s" % (self.signature(), len(want), got))
        trailing_ok = got[1:] == want[1:]
        batch_ok = self.dynamic_batch or got[0] == want[0]
        if not (trailing_ok and batch_ok):
            raise ValueError(
                "input shape %s does not match the exported signature %s"
                % (got, self.signature()))
        dt = str(x.dtype).replace("torch.", "")
        if want_dtype is not None and dt != want_dtype:
            raise ValueError(
                "input dtype %s does not match the exported dtype %s"
                % (dt, want_dtype))

    def signature(self):
        """Human-readable input signature, e.g. ``(N, 3, 224, 224)`` for a
        dynamic-batch artifact or ``(8, 3, 224, 224)`` for a fixed one."""
        shape = self.meta.get("input_shape") or ()
        dims = ["N" if self.dynamic_batch and i == 0 else str(d)
                for i, d in enumerate(shape)]
        return "(" + ", ".join(dims) + ")"

    def _env(self, params):
        if params is None:
            if self._params is None:
                raise ValueError("no params: artifact exported with "
                                 "include_params=False and none were "
                                 "given")
            return self._params
        if self.quantized:
            raise ValueError("a quantized predictor's int8 sites are "
                             "prepared at load from its shipped params; "
                             "params= is not taken")
        names = self.meta["param_names"]
        if len(params) != len(names):
            raise ValueError("params: %d arrays for %d parameters"
                             % (len(params), len(names)))
        return self._stage(dict(zip(names, (_host_array(p)
                                            for p in params))))

    def _forward(self, env, x):
        from .symbol.symbol import _eval_symbol
        env[self._input] = x
        return _eval_symbol(self._graph, env, False,
                            overrides=self._sites)[0]

    def run(self, x, params=None):
        """The program on a device tensor ``x`` (already validated):
        returns the output tensor on the device."""
        env = dict(self._env(params))
        with torch.inference_mode():
            if x.device.type == "cpu" and x.shape[0] > 1:
                return torch.cat([self._forward(env, x[i:i + 1])
                                  for i in range(x.shape[0])], dim=0)
            return self._forward(env, x)

    def predict(self, data, params=None):
        """Run inference; returns a host numpy array."""
        from .ndarray.ndarray import NDArray
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            self._validate_input(data)
            x = data.to(self.device)
        else:
            raw = _np.asarray(data)
            self._validate_input(raw)
            x = torch.from_numpy(_np.ascontiguousarray(raw)).to(
                self.device)
        return self.run(x, params).cpu().numpy()

    def forward(self, data):
        return self.predict(data)


def load_model(prefix, quantized=False, device=None):
    """Reload a one-shot artifact.  ``quantized=True`` is REQUIRED for a
    v3 int8 artifact (and refused for an f32 one): the flag is the
    caller's acknowledgement that the outputs carry int8 numerics."""
    return StableHLOPredictor(prefix, quantized=quantized, device=device)


# -------------------------------------------------------------- generation

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
        "format_version": GENERATE_FORMAT_VERSION,
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
        if self.format_version > GENERATE_FORMAT_VERSION:
            raise ValueError(
                "artifact %r is format v%d, newer than this build's v%d"
                % (prefix, self.format_version, GENERATE_FORMAT_VERSION))
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
