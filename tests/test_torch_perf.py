"""The port's ``mx.perf`` against the reference's on the CPU: an MLP's
FLOPs against XLA's cost analysis of the same widths, the op classes and
the roofline verdicts, a hand kernel counted once (its own analytic cost,
not its plain version's ops as well), the step records' ``flops``/``mfu``
validated by both packages, the registered programs of the hybridized
call, the Module's fused step and the serving warm-up, and
``perf.profile`` folding a captured step with the span trace."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu.perf as rperf
from mxnet_tpu import telemetry as rtel

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, perf, telemetry, tracing
from mxnet_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(autouse=True)
def _clean():
    perf.reset()
    telemetry.reset()
    yield
    for k in ("perf.profile", "perf.profile_dir", "telemetry.sink",
              "tracing.sink"):
        config.unset(k)
    perf.reset()
    telemetry.reset()


def _mlp_np(seed=0, b=64, f=256, h=512, o=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, f).astype(np.float32),
            rng.randn(f, h).astype(np.float32) * 0.05,
            rng.randn(h).astype(np.float32),
            rng.randn(h, o).astype(np.float32) * 0.05)


def test_mlp_flops_match_xla_cost_analysis():
    """Dense -> relu -> Dense: the port counts the two products
    (2 m n k each), XLA the products plus one FLOP an element of the bias
    add and the relu; they agree within 1% here (the products are 99.4%
    of XLA's count), and the counted run returns the uncounted outputs."""
    x, w1, b1, w2 = _mlp_np()

    def jfn(x, w1, b1, w2):
        return jnp.maximum(x @ w1 + b1, 0.0) @ w2

    def tfn(x, w1, b1, w2):
        return torch.relu(x @ w1 + b1) @ w2
    want = rperf.cost_analysis(jfn, x, w1, b1, w2)
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2)]
    out, got = perf.cost_analysis(tfn, *args)
    assert got["flops"] == 2 * 64 * 256 * 512 + 2 * 64 * 512 * 10
    assert abs(got["flops"] - want["flops"]) / want["flops"] < 0.01
    assert torch.equal(out, tfn(*args))
    assert got["bytes_accessed"] > 0
    classes = perf.hlo_op_classes(got["ops"])
    assert classes["matmul"] == 2 and classes["elementwise"] == 2


def test_classify_op_and_roofline_verdicts():
    want = {"aten::mm": "matmul", "aten.addmm.default": "matmul",
            "sm90_xmma_gemm_bf16bf16_bf16f32": "matmul",
            "flash_fwd_kernel": "matmul", "aten::convolution": "conv",
            "cudnn::bn_fw_tr_1C11_kernel": "conv",
            "ncclDevKernel_AllReduce_Sum_f32": "collective",
            "aten::sum": "reduction", "aten::_softmax": "reduction",
            "aten::copy_": "copy", "aten::index_select": "copy",
            "aten::add": "elementwise", "aten.mul.Tensor": "elementwise",
            "vectorized_elementwise_kernel<4, ...>": "elementwise",
            "sgd_multi_kernel": "elementwise", "aten::lstm": "other"}
    assert {n: perf.classify_op(n) for n in want} == want
    # the names the two packages share keep the reference's verdicts
    for name in ("dot", "convolution", "all-reduce", "reduce", "transpose",
                 "add", "fusion.42"):
        assert perf.classify_op(name) == rperf.classify_op(name), name
    assert perf.OP_CLASSES == rperf.OP_CLASSES
    assert perf.hlo_op_classes(["aten::mm", "aten::mm", "aten::relu"]) \
        == {"matmul": 2, "elementwise": 1}
    r = perf.roofline(1e12, 1e9)
    assert r["bound"] == "compute" and r["arithmetic_intensity"] == 1000.0
    assert r["device_intensity"] == round(989e12 / 3.35e12, 3)
    assert perf.roofline(1e9, 1e9)["bound"] == "bandwidth"
    assert perf.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert perf.peak_flops("NVIDIA H100 80GB HBM3", "int8") == 2 * 989e12
    assert perf.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3350e9
    with pytest.warns(RuntimeWarning, match="no peak figures"):
        assert perf.peak_flops("Some Other Card") == perf.DEFAULT_PEAK * 1e12


def test_hand_kernel_counted_once():
    """A flash call on the CPU runs its plain version; the count is the
    kernel's analytic cost (4 x D x heads x causal pairs), not that plus
    the plain version's products, and K3's list update charges 28 bytes
    an element (f32 master, moments and bf16 grad and cast)."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 24, 16).astype(np.float32))
               for _ in range(3))
    out, cost = perf.cost_analysis(ck.flash_attention, q, k, v, True)
    want = 4 * 2 * 3 * 16 * 24 * 25 // 2
    nbytes = 4 * 4 * 2 * 3 * 24 * 16 + 4 * 2 * 3 * 24   # q, k, v, o; lse
    assert cost["flops"] == want and cost["bytes_accessed"] == nbytes
    assert cost["kernels"] == {"flash_attention": {
        "calls": 1, "flops": want, "bytes": nbytes}}
    assert cost["ops"] == ["flash_attention"]
    assert all(torch.equal(a, b) for a, b in zip(
        out, ck.flash_attention(q, k, v, causal=True)))
    assert ck._cost_counter() is None
    n = 1000
    ws = [torch.zeros(n), torch.zeros(n // 2)]
    gs = [torch.ones(n, dtype=torch.bfloat16),
          torch.ones(n // 2, dtype=torch.bfloat16)]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    outs = [torch.empty_like(w, dtype=torch.bfloat16) for w in ws]
    _, cost = perf.cost_analysis(ck.fused_adam_step_multi, ws, gs, ms, vs,
                                 [1e-3] * 2, [0.0] * 2, 0.9, 0.999, 1e-8,
                                 outs=outs)
    assert cost["bytes_accessed"] == 28 * (n + n // 2)
    assert cost["ops"] == ["fused_adam_step_multi"]


def test_step_record_carries_flops_and_mfu(tmp_path):
    """A perf.wrap'ped program with a source inside telemetry.step_scope:
    the step record's flops and mfu, valid for both packages' validators,
    and the perf.mfu gauges."""
    path = tmp_path / "steps.jsonl"
    config.set("telemetry.sink", "jsonl:%s" % path)
    x, w1, b1, w2 = (torch.from_numpy(a) for a in _mlp_np(2))

    def step():
        return torch.relu(x @ w1 + b1) @ w2
    prog = perf.wrap(step, "gluon", "mlp_step", source="gluon",
                     dtype="bfloat16")
    for _ in range(3):
        with telemetry.step_scope("gluon", samples=64):
            prog()
    config.unset("telemetry.sink")
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    recs = [r for r in recs if r["event"] == "step"]
    assert len(recs) == 3
    flops = 2 * 64 * 256 * 512 + 2 * 64 * 512 * 10
    for r in recs:
        telemetry.validate_step_record(r)
        rtel.validate_step_record(r)
        assert r["flops"] == flops and r["mfu"] > 0
    rec = perf.program("gluon", "mlp_step")
    assert rec["calls"] == 3 and rec["flops"] == flops
    assert rec["peak_tflops"] == perf.DEFAULT_PEAK
    snap = telemetry.snapshot()["gauges"]
    assert snap["perf.mfu.gluon"] == recs[-1]["mfu"]
    # a step with no program leaves no flops
    with telemetry.step_scope("gluon"):
        pass
    assert perf.export()["programs"][0]["key"] == "mlp_step"


def test_signature_keys_the_counts():
    """A program counts once per signature: the whole argument walk by
    default, a caller's cheaper key (the SPMD step's batch shapes and
    flags, the Executor step's flags) where it names one, and never again
    with ``per_signature=False``; the arguments a key leaves out (per-tensor
    lr tuples, the optimizer state) do not cause a recount."""
    from mxnet_tpu_torch.parallel.trainer import _step_signature
    from mxnet_tpu_torch.symbol.symbol import _run_signature
    w = torch.ones(6, 4)

    def step(x, lrs, stats=None):
        return x @ w
    x4, x8 = torch.ones(4, 6), torch.ones(8, 6)
    prog = perf.wrap(step, "spmd", "sig", signature=lambda a, k: (
        perf.shape_key(a[0]), k.get("stats") is not None))
    prog(x4, (0.1,) * 3)
    prog(x4, (0.2,) * 5)
    assert [r["key"] for r in perf.programs("spmd")] == ["sig"]
    prog(x8, (0.1,))
    prog(x4, (), stats={})
    assert [r["key"] for r in perf.programs("spmd")] == [
        "sig", "sig@1", "sig@2"]
    assert perf.program("spmd", "sig")["calls"] == 2
    once = perf.wrap(step, "module", "once", per_signature=False)
    once(x4, ())
    once(x8, ())
    assert perf.program("module", "once")["calls"] == 2
    assert perf.program("module", "once")["flops"] == 2 * 4 * 6 * 4
    assert len(perf.programs("module")) == 1
    lrs = tuple(torch.zeros(()) for _ in range(3))
    assert _step_signature((x4, x4[:, 0], 1, lrs, lrs, 0, False, None),
                           {}) == \
        _step_signature((x4, x4[:, 0], 2, (), (), 3, False, None), {})
    assert _step_signature((x4, x4, 1, (), (), 0, True, None), {}) != \
        _step_signature((x4, x4, 1, (), (), 0, False, None), {})
    assert _run_signature(({}, {"w": w}, 1, (), ()), {}) == (False, None)
    assert _run_signature(({}, {}, 1, (), (), {}), {"guard": True}) == \
        (True, True)


def test_programs_of_the_wired_sites():
    """A hybridized Block's outermost call (gluon, the children not
    counted again), the Module's fused step (module) and a Server's warmed
    bucket (serving) register their records."""
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(8, in_units=6, activation="relu"),
                mt.gluon.nn.Dense(3, in_units=8))
        net.initialize()
        net.hybridize()
        x = mt.nd.array(np.ones((4, 6), np.float32))
        net(x)
        net(x)
    recs = perf.programs("gluon")
    assert len(recs) == 1 and recs[0]["calls"] == 2
    assert recs[0]["flops"] == 2 * 4 * 6 * 8 + 2 * 4 * 8 * 3
    with mt.cpu():
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=5, name="fc1")
        out = mt.sym.SoftmaxOutput(h, mt.sym.Variable("softmax_label"),
                                   name="sm")
        mod = mt.mod.Module(out, context=mt.cpu())
        mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
        mod.init_params(mt.init.Xavier())
        mod.init_optimizer(optimizer="adam")
        batch = mt.io.DataBatch([mt.nd.array(np.ones((4, 6), np.float32))],
                                [mt.nd.array(np.zeros(4, np.float32))])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
    mrecs = perf.programs("module")
    assert len(mrecs) == 1 and mrecs[0]["calls"] >= 1
    assert mrecs[0]["flops"] >= 3 * 2 * 4 * 6 * 5   # forward + backward


def test_profile_step_capture_folds_with_the_span_trace(tmp_path):
    """perf.profile=step:2 over 5 steps: captures after steps 2 and 4
    cover steps 3 and 5, each folded with the chrome span trace; a bad
    spec is refused and the knob reverts."""
    trace = tmp_path / "spans.json"
    config.set("tracing.sink", "chrome:%s" % trace)
    config.set("perf.profile_dir", str(tmp_path))
    config.set("perf.profile", "step:2")
    n0 = len(perf.captures())
    x = torch.ones(32, 32)
    for _ in range(5):
        with telemetry.step_scope("spmd"), tracing.span("step"):
            (x @ x).sum()
    config.unset("perf.profile")
    caps = perf.captures()[n0:]
    assert [os.path.basename(c) for c in caps] == ["perf_step_spmd_3",
                                                   "perf_step_spmd_5"]
    for c in caps:
        meta = json.load(open(os.path.join(c, "meta.json")))
        assert meta["merged"]["host_events"] >= 1 and not meta["cuda"]
        assert os.path.exists(os.path.join(c, "merged.json"))
    with pytest.raises(ValueError):
        config.set("perf.profile", "every:2")
    assert config.get("perf.profile") == ""
