"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one H100.

Usage (from the root of a checkout, one visible CUDA card)::

    python3 chip_smoke.py [--report PATH]

Phases; any failure exits non-zero without the result lines:

1. build  — compile every kernel of ``mxnet_tpu_torch/csrc`` for sm_90a
            (one ``nvcc`` per source, in parallel) into ``build/kernels``.
2. kernels — each kernel against its plain PyTorch version on the same
            seeded bf16 inputs at the served shapes: flash-attention forward
            (causal S = 128, 1024, 2048; non-causal Sq=256, Skv=1024) and
            paged decode, bf16 and int8 pages (B=8, K = 16, 512, 2048,
            ragged valid prefixes).  Prints each max abs error against its
            stated tolerance, kernel / plain / library ms and the bound.
            Tolerance, per output row (one (b, h, query)): max |kernel -
            plain| <= ROW_REL_TOL x max |plain| of that row.
3. serve  — the full-width TransformerLM (TransformerLMConfig defaults:
            vocab 32000, d_model 768, 12 heads, d_ff 3072, 12 layers,
            max_len 2048, bf16; seeded random weights) through
            export_generation -> Server.register(generate=True) -> start:
            16 greedy requests at once (prompts of 17..1500 tokens, 32 new
            tokens each), then a short int8-KV run and a seeded sampled
            run.  Kernel launch counts and telemetry are zeroed just
            before each of the three runs and read just after: every
            prefill layer must have run the flash kernel and every decode
            layer the paged kernel of the run's page dtype, and nothing
            else.  Each greedy stream is held against the plain ``apply()``
            with the kernel tier off, teacher-forced.
4. summary — a ``{"kernels": [...]}`` line, the card's name and power
            limit, and as the last line ``{"ok": true, "device": {...}}``.

Numerics: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False, so every f32 product
of the plain versions and of the logits readout is full f32.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs plain version, per output row (one (b, h, query)): bf16 keeps
# 8 significant bits, so one ulp is at most 2^-7 of a value.  The two sides
# round at different points — P to bf16, the P.V sum, the row sum, the
# divide, the output — at most five half-ulp roundings between them,
# 2.5 x 2^-7 < 2^-5 of the row's largest |o|.  The limit scales with each
# row, so it stays below a typical value of what it compares: a kernel that
# drops one 64-key tile of a row over K random keys moves it by about
# sqrt(64 / K) of its size, 0.18 at K = 2048, 5.7x the limit.
ROW_REL_TOL = 2.0 ** -5
# lse is f32 statistics over the same bf16 scores summed in another order.
LSE_ATOL = 1e-3
# Served greedy tokens vs the plain teacher-forced argmax: a mismatch is
# excused only where the plain top-2 logit margin is below this.  On the
# H100 the kernels move the serving path's logits by ~0.03 against the
# plain bf16 path (both sides carry bf16 round-off of the same size; see
# PERF.md), so flips are expected only below that.
LOGIT_MARGIN_TOL = 0.05
# Replaying served streams on an f32 copy of the weights: the kernel
# path's logit error may be at most this multiple of the plain bf16
# path's own error (a faulty kernel shows errors of order 1).
KERNEL_VS_PLAIN_ERR = 2.0

SEED = 0
N_REQUESTS = 16
NEW_TOKENS = 32
KV_PAGES = 1024


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _row_rel_err(o, po):
    """max over output rows of max|o - po| / max|po| within the row."""
    o = o.float().reshape(-1, o.shape[-1])
    po = po.float().reshape(-1, po.shape[-1])
    err = (o - po).abs().amax(dim=-1)
    return float((err / po.abs().amax(dim=-1).clamp_min(1e-30)).max())


def _bound_ms(nbytes, flops):
    t_b = nbytes / PEAK_HBM_BYTES
    t_f = flops / PEAK_BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------- phase 2
def check_flash(ck, torch, F):
    cases = []
    B, H, D = 1, 12, 64
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for causal, sq, skv in ((True, 128, 128), (True, 1024, 1024),
                            (True, 2048, 2048), (False, 256, 1024)):
        q = torch.randn(B, H, sq, D, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, H, skv, D, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, H, skv, D, generator=g, device="cuda").bfloat16()
        o, lse = ck.flash_attention(q, k, v, causal=causal)
        po, plse = ck.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((o.float() - po.float()).abs().max())
        row_err = _row_rel_err(o, po)
        lse_err = float((lse - plse).abs().max())
        ok = (row_err <= ROW_REL_TOL and lse_err <= LSE_ATOL
              and bool(torch.isfinite(o.float()).all()))
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        nbytes = 2 * (2 * B * H * sq * D + 2 * B * H * skv * D) \
            + 4 * B * H * sq
        bound, by = _bound_ms(nbytes, 4 * B * H * D * pairs)
        case = {
            "shape": {"B": B, "H": H, "Sq": sq, "Skv": skv, "D": D,
                      "causal": causal, "dtype": "bfloat16"},
            "max_abs_err": err, "max_row_rel_err": row_err,
            "row_rel_tol": ROW_REL_TOL, "lse_max_abs_err": lse_err,
            "lse_tol": LSE_ATOL, "ok": ok,
            "ms": _time_ms(lambda: ck.flash_attention(q, k, v,
                                                      causal=causal)),
            "plain_ms": _time_ms(lambda: ck.flash_attention_plain(
                q, k, v, causal=causal)),
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            "bound_ms": bound, "bound_by": by}
        _log("[kernels] flash_fwd %s" % json.dumps(case))
        cases.append(case)
    return cases


def _paged_inputs(torch, quant, B, H, K, D, g):
    from mxnet_tpu_torch.quantization import quantize_rows
    q = torch.randn(B, H, 1, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, H, K, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, H, K, D, generator=g, device="cuda").bfloat16()
    lens = torch.randint(1, K + 1, (B,), generator=g, device="cuda")
    lens[0] = K          # one full row, one single-position row
    lens[-1] = 1
    valid = torch.arange(K, device="cuda")[None, :] < lens[:, None]
    if quant:
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        return q, kq, vq, valid, ks, vs, lens
    return q, k, v, valid, None, None, lens


def check_paged(ck, torch, F, quant):
    cases = []
    B, H, D = 8, 12, 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 1 + int(quant))
    for K in (16, 512, 2048):
        q, k, v, valid, ks, vs, lens = _paged_inputs(torch, quant, B, H, K,
                                                     D, g)
        kw = {"k_scale": ks, "v_scale": vs} if quant else {}
        o = ck.paged_attention(q, k, v, valid, **kw)
        po = ck.paged_attention_plain(q, k, v, valid, **kw)
        torch.cuda.synchronize()
        err = float((o.float() - po.float()).abs().max())
        row_err = _row_rel_err(o, po)
        ok = (row_err <= ROW_REL_TOL
              and bool(torch.isfinite(o.float()).all()))
        n_valid = int(lens.sum()) * H
        elem = 1 if quant else 2
        nbytes = (n_valid * D * 2 * elem + (n_valid * 2 * 4 if quant else 0)
                  + 2 * 2 * B * H * D + B * K)
        bound, by = _bound_ms(nbytes, 4 * D * n_valid)
        lib = None
        if not quant:
            mask = valid[:, None, None, :]
            lib = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
        case = {
            "shape": {"B": B, "H": H, "K": K, "D": D,
                      "valid": [int(x) for x in lens.tolist()],
                      "pages": "int8" if quant else "bfloat16"},
            "max_abs_err": err, "max_row_rel_err": row_err,
            "row_rel_tol": ROW_REL_TOL, "ok": ok,
            "ms": _time_ms(lambda: ck.paged_attention(q, k, v, valid, **kw),
                           iters=50),
            "plain_ms": _time_ms(lambda: ck.paged_attention_plain(
                q, k, v, valid, **kw), iters=50),
            "library_ms": lib, "bound_ms": bound, "bound_by": by}
        _log("[kernels] paged_decode_%s %s" % ("int8" if quant else "bf16",
                                               json.dumps(case)))
        cases.append(case)
    return cases


# ------------------------------------------------------------- phase 3
def _prompts(np, vocab):
    rng = np.random.default_rng(SEED)
    lens = np.linspace(17, 1500, N_REQUESTS).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def _teacher_forced_check(mx, model, np, torch, prompts, streams):
    """Every served token vs the plain (tier-off) argmax, teacher-forced.
    Returns (tokens checked, the plain top-2 margins of the mismatches,
    each excused as a near-tie below LOGIT_MARGIN_TOL)."""
    checked, tie_margins = 0, []
    mx.config.set("kernels.enabled", False)
    try:
        for pr, st in zip(prompts, streams):
            seq = np.concatenate([pr, st[:-1]]).astype(np.int64)
            logits = model.apply(seq[None])[0, len(pr) - 1:]
            top2 = torch.topk(logits, 2, dim=-1)
            plain = top2.indices[:, 0].cpu().numpy()
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            for i, tok in enumerate(st):
                checked += 1
                if int(tok) == int(plain[i]):
                    continue
                if margin[i] < LOGIT_MARGIN_TOL:
                    tie_margins.append(float(margin[i]))
                    continue
                raise AssertionError(
                    "served token %d at step %d of a %d-token prompt "
                    "disagrees with the plain argmax %d (margin %.4f >= "
                    "%.4f)" % (tok, i, len(pr), plain[i], margin[i],
                               LOGIT_MARGIN_TOL))
    finally:
        mx.config.unset("kernels.enabled")
    return checked, tie_margins


def _replay_logits(mx, model, np, torch, prompt, stream, quantized, tier):
    """Logits of one served stream replayed through prefill + decode_step
    (B=1, its own page pool) with the kernel tier on or off."""
    psz = 16
    pages = -(-(len(prompt) + len(stream)) // psz)
    table = np.arange(pages, dtype=np.int32)[None]
    mx.config.set("kernels.enabled", tier)
    try:
        kv = model.init_kv_pages(pages, psz, quantized=quantized)
        kv, _, lg = model.prefill(kv, prompt[None], np.asarray([len(prompt)]),
                                  table, psz, return_logits=True)
        out = [lg]
        for i, tok in enumerate(stream[:-1]):
            kv, _, lg = model.decode_step(
                kv, np.asarray([tok]), np.asarray([len(prompt) + i]), table,
                psz, return_logits=True)
            out.append(lg)
    finally:
        mx.config.unset("kernels.enabled")
    return torch.cat(out).float()


def _kernel_accuracy(mx, model, model32, np, torch, prompt, stream,
                     quantized):
    """How far the kernels move the serving path's logits: the replayed
    stream's logits with the kernel tier on and off (bf16 model), and the
    same replay on an f32 copy of the weights as the reference.  Returns
    (|on - off|, |on - f32|, |off - f32|), each a max over the stream."""
    on = _replay_logits(mx, model, np, torch, prompt, stream, quantized, True)
    off = _replay_logits(mx, model, np, torch, prompt, stream, quantized,
                         False)
    ref = _replay_logits(mx, model32, np, torch, prompt, stream, quantized,
                         False)
    return (float((on - off).abs().max()), float((on - ref).abs().max()),
            float((off - ref).abs().max()))


def _profiler_records_cuda(torch):
    """True when torch.profiler records CUDA kernels here, probed on one
    small product before any request is served in a profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x = torch.ones(64, 64, device="cuda")
            float((x @ x).sum())
    except RuntimeError:
        return False
    return any(ev.device_type == DeviceType.CUDA for ev in prof.events())


def _profile_window(srv, torch, prompts):
    """torch.profiler over 8 concurrent requests (256-token prompts, 16 new
    tokens): wall time, summed CUDA kernel time and the device's idle
    share, plus the kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [srv.submit_generate("lm", pr[:256], 16)
                for pr in prompts[:8]]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "top_kernels_ms": [[n[:80], t] for n, t in top]}


def _zero_counts(torch, tt, ck):
    """Zero the launch counts and telemetry just before a counted run."""
    torch.cuda.synchronize()
    tt.reset()
    ck.reset_launches()


def _read_counts(torch, tt, ck, layers, paged_key):
    """Read a counted run just after it: every prefill layer ran the flash
    kernel and every decode layer the paged kernel ``paged_key``, through
    the routed wrappers, and no other kernel launched.  Returns
    (prefills, decode iterations, launches, telemetry snapshot)."""
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    snap = tt.snapshot()
    c, tm = snap["counters"], snap["timers"]
    prefills = tm.get("serving.prefill_ms", {}).get("count", 0)
    decodes = tm.get("serving.decode_step_ms", {}).get("count", 0)
    assert prefills > 0 and decodes > 0, (prefills, decodes)
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd": prefills * layers,
                 paged_key: decodes * layers})
    assert launches == want, (launches, want)
    assert c.get("kernels.flash_attention", 0) == prefills * layers, c
    assert c.get("kernels.paged_attention", 0) == decodes * layers, c
    return prefills, decodes, launches, snap


def serve(mx, ck, np, torch, workdir):
    from mxnet_tpu_torch import telemetry as tt
    from mxnet_tpu_torch.models.transformer import (TransformerLM,
                                                    TransformerLMConfig)
    out = {}
    cfg = TransformerLMConfig()
    t0 = time.perf_counter()
    model = TransformerLM(cfg).init(SEED)
    nparams = sum(p.numel() for p in model.parameters())
    prefix = os.path.join(workdir, "lm")
    prefixq = os.path.join(workdir, "lmq")
    mx.deploy.export_generation(model, None, prefix, sampling=True)
    mx.deploy.export_generation(model, None, prefixq, kv_quantized=True)
    out["setup_s"] = time.perf_counter() - t0
    out["params"] = nparams
    mx.config.set("serving.kv_pages", KV_PAGES)
    srv = mx.serving.Server()
    try:
        eng = srv.register("lm", prefix, generate=True)
        engq = srv.register("lmq", prefixq, generate=True)
        srv.start()
        gp = eng.predictor
        assert gp.page_size == 16 and eng.decode_slots == 8
        assert all(r["impl"] == "paged" for r in gp.paged_routes.values())
        prompts = _prompts(np, cfg.vocab_size)
        # warm-up outside the counted run (library handles, allocator)
        srv.generate("lm", prompts[0][:64], 4, timeout=600)

        L = cfg.num_layers
        # --- the main path: counts zeroed just before, read just after
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        futs = [srv.submit_generate("lm", pr, NEW_TOKENS) for pr in prompts]
        streams = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        prefills, decodes, launches, snap = _read_counts(
            torch, tt, ck, L, "paged_decode_bf16")
        tm = snap["timers"]
        assert prefills == N_REQUESTS, prefills
        assert all(len(s) == NEW_TOKENS for s in streams)
        out["greedy"] = {
            "requests": N_REQUESTS,
            "prompt_lens": [int(len(p)) for p in prompts],
            "new_tokens": NEW_TOKENS, "prefills": prefills,
            "decode_iterations": decodes, "wall_s": wall,
            "tokens_per_s": N_REQUESTS * NEW_TOKENS / wall,
            "ttft_ms_p50": tm["serving.ttft_ms"]["p50"],
            "ttft_ms_p99": tm["serving.ttft_ms"]["p99"],
            "prefill_ms_p50": tm["serving.prefill_ms"]["p50"],
            "decode_step_ms_p50": tm["serving.decode_step_ms"]["p50"],
            "decode_step_ms_p99": tm["serving.decode_step_ms"]["p99"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}
        _log("[serve] greedy %s" % json.dumps(out["greedy"]))
        checked, ties = _teacher_forced_check(mx, model, np, torch, prompts,
                                              streams)
        lens = [len(p) for p in prompts]
        pick = (lens.index(min(lens)), lens.index(max(lens)))
        model32 = TransformerLM(TransformerLMConfig(dtype=torch.float32))
        model32.load_state_dict(model.state_dict())
        acc = {}
        for quant in (False, True):
            rows = [_kernel_accuracy(mx, model, model32, np, torch,
                                     prompts[i], streams[i], quant)
                    for i in pick]
            acc[quant] = [max(r[j] for r in rows) for j in range(3)]
            # the kernel path may be no less accurate than the plain bf16
            # path, judged against the f32 weights
            assert acc[quant][1] <= KERNEL_VS_PLAIN_ERR * acc[quant][2], \
                (quant, acc[quant])
        del model32
        out["greedy"].update({
            "checked_tokens": checked, "near_ties": len(ties),
            "near_tie_max_margin": max(ties, default=0.0),
            "logit_kernel_vs_plain_bf16_kv": acc[False][0],
            "logit_err_vs_f32_kernel_bf16_kv": acc[False][1],
            "logit_err_vs_f32_plain_bf16_kv": acc[False][2],
            "logit_kernel_vs_plain_int8_kv": acc[True][0],
            "logit_err_vs_f32_kernel_int8_kv": acc[True][1],
            "logit_err_vs_f32_plain_int8_kv": acc[True][2]})
        _log("[serve] parity: %d tokens held against the plain argmax, "
             "%d near-tie(s) below margin %.3f (largest %.4f)"
             % (checked, len(ties), LOGIT_MARGIN_TOL, max(ties, default=0.0)))
        _log("[serve] logits on the serving path, max |diff|: kernel vs "
             "plain %.4f / %.4f, kernel vs f32 %.4f / %.4f, plain vs f32 "
             "%.4f / %.4f (bf16 KV / int8 KV)"
             % (acc[False][0], acc[True][0], acc[False][1], acc[True][1],
                acc[False][2], acc[True][2]))

        # --- int8 KV pages: counts zeroed just before, read just after
        _zero_counts(torch, tt, ck)
        t0 = time.perf_counter()
        futq = [srv.submit_generate("lmq", pr, 16) for pr in prompts[:8]]
        sq = [f.result(timeout=600) for f in futq]
        wall = time.perf_counter() - t0
        prefills, decodes, launches, _ = _read_counts(torch, tt, ck, L,
                                                      "paged_decode_int8")
        assert prefills == 8, prefills
        agree = float(np.mean([np.mean(a == b[:16])
                               for a, b in zip(sq, streams[:8])]))
        out["int8"] = {"requests": 8, "new_tokens": 16, "wall_s": wall,
                       "prefills": prefills, "decode_iterations": decodes,
                       "launches": launches,
                       "token_agreement_with_bf16_kv": agree}
        _log("[serve] int8 %s" % json.dumps(out["int8"]))

        # --- seeded sampling, one seed one stream: counts zeroed just
        # before, read just after
        _zero_counts(torch, tt, ck)
        rep = [srv.generate("lm", prompts[0], 16, temperature=0.8, top_k=50,
                            top_p=0.95, seed=1234, timeout=600)
               for _ in range(2)]
        other = srv.generate("lm", prompts[0], 16, temperature=0.8,
                             top_k=50, top_p=0.95, seed=4321, timeout=600)
        prefills, decodes, launches, _ = _read_counts(torch, tt, ck, L,
                                                      "paged_decode_bf16")
        assert prefills == 3, prefills
        assert np.array_equal(rep[0], rep[1]), (rep[0], rep[1])
        out["sampling"] = {"replay_equal": True,
                           "other_seed_differs": bool(
                               not np.array_equal(rep[0], other)),
                           "prefills": prefills,
                           "decode_iterations": decodes,
                           "launches": launches}
        _log("[serve] sampling %s" % json.dumps(out["sampling"]))

        # --- where a served decode step's time goes (device idle share);
        # a failure of the served requests in this window fails the run
        if _profiler_records_cuda(torch):
            out["profile"] = _profile_window(srv, torch, prompts)
        else:
            out["profile"] = {"error": "not measured: torch.profiler "
                                       "recorded no CUDA kernels"}
        _log("[serve] profile %s" % json.dumps(out["profile"]))
    finally:
        srv.stop()
        mx.config.unset("serving.kv_pages")
    return out


def _summary(name, replaces, cases, launches):
    """One line of the kernels table; its times are those of the largest
    served shape (causal S=2048, or K=2048)."""
    top = max(cases, key=lambda c: c["bound_ms"])
    return {"name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/%s" % (
                "flash_fwd.cu" if name == "flash_fwd" else "paged_attn.cu"),
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_row_rel_err": max(c["max_row_rel_err"] for c in cases),
            "row_rel_tol": ROW_REL_TOL,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": top["shape"],
            "cases": cases}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write the full report (JSON) "
                    "to this path")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "nvidia_smi": card}
    _log("[env] %s" % json.dumps(report))

    t0 = time.perf_counter()
    built = _build.build()
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "per_source_s": {k: v["seconds"]
                                        for k, v in built.items()}}
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                _log("[build] %s: %s" % (name, line.strip()))
    _log("[build] %s" % json.dumps(report["build"]))

    flash = check_flash(ck, torch, F)
    paged = check_paged(ck, torch, F, quant=False)
    paged8 = check_paged(ck, torch, F, quant=True)
    bad = [c for c in flash + paged + paged8 if not c["ok"]]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % json.dumps(bad))

    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    report["serve"] = serve(mx, ck, np, torch, workdir)
    launches = report["serve"]["greedy"]["launches"]
    kernels = [
        _summary("flash_fwd", "mxnet_tpu/ops/pallas_kernels.py:157",
                 flash, launches["flash_fwd"]),
        _summary("paged_decode_bf16", "mxnet_tpu/ops/pallas_kernels.py:386",
                 paged, launches["paged_decode_bf16"]),
        _summary("paged_decode_int8", "mxnet_tpu/ops/pallas_kernels.py:386",
                 paged8, report["serve"]["int8"]["launches"][
                     "paged_decode_int8"]),
    ]
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in s.items()
                                   if k != "cases"} for s in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — report and fail the run
        import traceback
        traceback.print_exc()
        print("chip_smoke: FAILED (%s: %s)" % (type(exc).__name__, exc),
              file=sys.stderr)
        sys.exit(1)
