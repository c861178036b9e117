"""The port's ``mx.resilience`` held against the reference's on the CPU.

- The non-finite step guard on the three training loops, in the shapes
  of the reference's tests (``tests/test_resilience.py``): the guarded
  ``SPMDTrainer`` loop (an MLP with BatchNorm, weights carried across),
  the Module's fused loop and the Gluon eager loop, each with the ``nan``
  fault at one step, against the reference's guarded loop at the
  existing parity bounds (``SPMDTrainer``: losses within rtol 1e-5,
  parameters within rtol 1e-4 / atol 1e-5; Module: rtol 1e-5 / atol
  1e-7; Gluon: 1e-5).  In the port a skipped step is bitwise a run that
  never took that batch: parameters, optimizer state and BatchNorm
  statistics, with the kernel tier on (K1's plain version takes the skip
  word) and off (``optimizer.step`` and ``torch.where``); the row-sparse
  route and the 2-bit compressed step (its residuals rolled back) too.
  Under SGD, whose update does not read the step count: the step count
  advances on a skipped step in both packages.
- Checkpoint manifests across the packages: each package's
  ``verify_checkpoint`` accepts the other's checkpoint and manifest, and
  the port's ``CheckpointManager.restore`` loads a reference-written
  ``SPMDTrainer`` checkpoint.
- The manager's retention, ``latest``, the fallback past a truncated
  file, a ``ckpt_write`` fault that keeps the previous file loadable, the
  SIGTERM save-and-resume (bitwise with an uninterrupted run), retried
  ``io`` and ``kvstore`` faults with their counters, the abort with its
  last-good checkpoint, and the skip word's plain versions (K1, K3).
"""
import os
import pickle
import signal

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU)

import mxnet_tpu as jmx
from mxnet_tpu import config as jconfig
from mxnet_tpu import resilience as jres

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.name as tname
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

from test_torch_persistence import _spmd_pair, _spmd_batch

SPMD_LOSS_RTOL = 1e-5
SPMD_RTOL, SPMD_ATOL = 1e-4, 1e-5
MODULE_RTOL, MODULE_ATOL = 1e-5, 1e-7
GLUON_TOL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _knobs(tmp_path):
    """Every resilience knob of both packages at its default around each
    test, fast retries, zeroed counters, the CPU, and the port's abort
    reports in the test's directory."""
    tconfig.set("tracing.watchdog_dir", str(tmp_path))
    def reset():
        for config, res in ((jconfig, jres), (tconfig, tres)):
            config.set("resilience.nanguard", "")
            config.set("resilience.faults", "")
            config.set("resilience.fault_seed", 0)
            config.set("resilience.on_preempt", "")
            config.set("resilience.retry_attempts", 3)
            config.set("resilience.retry_base_s", 0.001)
            res.reset_nanguard()
            res.clear_preempt()
        tt.reset()
    reset()
    with mt.cpu():
        yield
    reset()
    for config in (jconfig, tconfig):
        config.set("resilience.retry_base_s", 0.05)
    tconfig.unset("kernels.enabled")
    tconfig.unset("tracing.watchdog_dir")


def _both(knob, value):
    jconfig.set(knob, value)
    tconfig.set(knob, value)


def _state(tr):
    """A port trainer's weights, BatchNorm statistics and optimizer state
    as numpy, by name."""
    out = {"p/" + n: v.detach().numpy().copy() for n, v in tr.params.items()}
    for n, s in tr.opt_state.items():
        if s is not None:
            leaves = s if isinstance(s, (list, tuple)) else [s]
            for i, leaf in enumerate(leaves):
                out["s/%s/%d" % (n, i)] = leaf.numpy().copy()
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


# ------------------------------------------------ nanguard: SPMDTrainer
SPMD_STEPS, SPMD_NAN = 5, 3


def _port_spmd(skip_batch=None, tier=True):
    tconfig.set("kernels.enabled", tier)
    _, tr = _spmd_pair("sgd", SGD)
    losses = []
    for i in range(SPMD_STEPS):
        if i + 1 == skip_batch:
            continue
        x, y = (torch.from_numpy(a) for a in _spmd_batch(i))
        losses.append(float(tr.step(x, y)))
    tres.poll_streaks(block=True)
    return tr, losses


@pytest.mark.parametrize("tier", [True, False], ids=["tier_on", "tier_off"])
def test_spmd_nanguard_skip_matches_reference(tier):
    """The guarded loop with the nan fault at step 3 against the
    reference's: the same NaN step, the same losses and weights; and the
    port's run is bitwise the one that never took batch 3."""
    _both("resilience.nanguard", "skip")
    _both("resilience.faults", "nan:1@step=%d" % SPMD_NAN)
    jtr, _ = _spmd_pair("sgd", SGD)
    jl = [float(jtr.step(*_spmd_batch(i))) for i in range(SPMD_STEPS)]
    jres.poll_streaks(block=True)
    tr, tl = _port_spmd(tier=tier)
    assert np.isnan(jl[SPMD_NAN - 1]) and np.isnan(tl[SPMD_NAN - 1])
    keep = [i for i in range(SPMD_STEPS) if i != SPMD_NAN - 1]
    np.testing.assert_allclose([tl[i] for i in keep], [jl[i] for i in keep],
                               rtol=SPMD_LOSS_RTOL)
    assert tt.counter("spmd.nonfinite_steps").value == 1
    assert tres.nonfinite_stats("spmd") == {"streak": 0, "total": 1}
    jtr.sync()
    tr.sync()
    jp = {n[len(jtr.block.prefix):]: p.data().asnumpy()
          for n, p in jtr.block.collect_params().items()}
    for n, p in tr.block.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[n[len(tr.block.prefix):]],
                                   rtol=SPMD_RTOL, atol=SPMD_ATOL, err_msg=n)
    guarded = _state(tr)
    _both("resilience.faults", "")
    tres.reset_nanguard()
    never, _ = _port_spmd(skip_batch=SPMD_NAN, tier=tier)
    _assert_bitwise(guarded, _state(never))


def test_spmd_nanguard_off_takes_the_nan():
    """Without the guard the NaN batch reaches the weights: the skip
    above is the guard's doing."""
    tconfig.set("resilience.faults", "nan:1@step=%d" % SPMD_NAN)
    tr, losses = _port_spmd()
    assert all(np.isnan(losses[SPMD_NAN - 1:]))
    assert any(np.isnan(v).any() for v in _state(tr).values())


def test_spmd_routed_table_skip_is_bitwise():
    """The row-sparse route: a NaN label drops the step, the table's rows
    and their momentum included, bitwise a run without that batch."""
    from test_torch_embedding import _net as emb_net, _batches as emb_batches
    tconfig.set("resilience.nanguard", "skip")
    ids, labels, pads = emb_batches()

    def run(poison=None, skip=None):
        tres.reset_nanguard()
        mt.random.seed(3)
        with tname.NameManager():
            net = emb_net(mt)
        net.initialize(ctx=mt.cpu())
        tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "sgd", dict(SGD),
                         mesh=make_mesh({"dp": 1}, [mt.cpu()]))
        for i, (x, y, pad) in enumerate(zip(ids, labels, pads)):
            if i == skip:
                continue
            if i == poison:
                y = y * np.float32("nan")
            tr.step(x, y, pad=pad)
        assert tr._routed()
        tres.poll_streaks(block=True)
        return _state(tr)
    _assert_bitwise(run(poison=0), run(skip=0))
    assert tt.counter("spmd.nonfinite_steps").value == 1


def test_compressed_step_rolls_back_its_residuals():
    """A dropped 2-bit compressed step leaves the weights and the
    error-feedback residuals as they were (the reference's
    ``test_compressed_nanguard_rolls_back_residuals``, on a one-rank
    ``{"dcn": 1}`` mesh)."""
    tconfig.set("kvstore.grad_compress", "2bit")
    tconfig.set("resilience.nanguard", "skip")
    try:
        mt.random.seed(42)
        with tname.NameManager():
            net = mt.gluon.nn.Dense(4, in_units=16)
        net.initialize(ctx=mt.cpu())
        tr = SPMDTrainer(net, mt.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1},
                         mesh=make_mesh({"dcn": 1}, [mt.cpu()]))
        rng = np.random.RandomState(3)
        batches = [(rng.randn(8, 16).astype("f4"),
                    rng.randn(8, 4).astype("f4")) for _ in range(3)]
        tr.step(*batches[0])
        before = _state(tr)
        res = {n: r.clone() for n, r in tr._dcn_residuals.items()}
        tconfig.set("resilience.faults", "nan:1")
        assert not np.isfinite(float(tr.step(*batches[1])))
        tconfig.set("resilience.faults", "")
        _assert_bitwise(before, _state(tr))
        for n, r in tr._dcn_residuals.items():
            assert torch.equal(r, res[n]), n
        assert np.isfinite(float(tr.step(*batches[2])))
    finally:
        tconfig.set("kvstore.grad_compress", "")


# ------------------------------------------- nanguard: Module fused loop
MOD_STEPS, MOD_NAN = 5, 3


def _module_run(lib, config, poison=None, skip=None, route="on"):
    """The reference's Module test shape: FC 8, relu, FC 4, SoftmaxOutput,
    SGD 0.1 over 5 batches of 8 x 6, from fixed weights."""
    config.set("resilience.nanguard", "skip")
    config.set("module.fused_step", route)
    try:
        rng = np.random.RandomState(3)
        init = {"fc1_weight": (rng.randn(8, 6) * 0.3).astype("f4"),
                "fc1_bias": np.zeros(8, "f4"),
                "fc2_weight": (rng.randn(4, 8) * 0.3).astype("f4"),
                "fc2_bias": np.zeros(4, "f4")}
        X = rng.randn(MOD_STEPS * 8, 6).astype("f4")
        Y = (rng.rand(MOD_STEPS * 8) * 4).astype("f4")
        data = lib.sym.Variable("data")
        h = lib.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = lib.sym.Activation(h, act_type="relu", name="relu1")
        h = lib.sym.FullyConnected(h, num_hidden=4, name="fc2")
        out = lib.sym.SoftmaxOutput(h, lib.sym.Variable("softmax_label"),
                                    name="softmax")
        kw = {"context": mt.cpu()} if lib is mt else {}
        mod = lib.mod.Module(out, data_names=["data"],
                             label_names=["softmax_label"], **kw)
        it = lib.io.NDArrayIter(X, Y, batch_size=8,
                                label_name="softmax_label")
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=None, arg_params={
            k: lib.nd.array(v) for k, v in init.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        for step, batch in enumerate(it, 1):
            if step == skip:
                continue
            if step == poison:
                batch.data = [lib.nd.array(batch.data[0].asnumpy() * np.nan)]
            mod.train_step(batch)
        arg, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in arg.items()}
    finally:
        config.unset("module.fused_step") if config is tconfig else \
            config.set("module.fused_step", "on")


@pytest.mark.parametrize("route", ["on", "off"], ids=["fused", "eager"])
def test_module_nanguard_skip_matches_reference(route):
    """The Module loop with a NaN batch at step 3 against the reference's
    fused loop; the port's fused route (the skip word into K1's plain
    version) and eager route (the host check) are bitwise the run
    without that batch."""
    ref = _module_run(jmx, jconfig, poison=MOD_NAN)
    jres.poll_streaks(block=True)
    got = _module_run(mt, tconfig, poison=MOD_NAN, route=route)
    tres.poll_streaks(block=True)
    assert tt.counter("module.nonfinite_steps").value == 1
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=MODULE_RTOL,
                                   atol=MODULE_ATOL, err_msg=k)
    never = _module_run(mt, tconfig, skip=MOD_NAN, route=route)
    _assert_bitwise(got, never)


# --------------------------------------------- nanguard: Gluon eager loop
def _gluon_run(lib, poison=None, skip=None):
    lib.config.set("resilience.nanguard", "skip")
    kw = {"ctx": mt.cpu()} if lib is mt else {}
    net = lib.gluon.nn.Dense(4, in_units=6)
    net.initialize(**kw)
    rng = np.random.RandomState(5)
    net.weight.set_data(lib.nd.array(rng.randn(4, 6).astype("f4") * 0.3))
    net.bias.set_data(lib.nd.array(np.zeros(4, "f4")))
    tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    loss_fn = lib.gluon.loss.L2Loss()
    for step in range(1, 7):
        x = rng.randn(8, 6).astype("f4")
        y = rng.randn(8, 4).astype("f4")
        if step == skip:
            continue
        if step == poison:
            x = x * np.nan
        with lib.autograd.record():
            loss = loss_fn(net(lib.nd.array(x)), lib.nd.array(y))
        loss.backward()
        tr.step(8)
    return {"w": net.weight.data().asnumpy(), "b": net.bias.data().asnumpy()}


def test_gluon_nanguard_skip_matches_reference():
    ref = _gluon_run(jmx, poison=3)
    got = _gluon_run(mt, poison=3)
    assert tt.counter("gluon.nonfinite_steps").value == 1
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=GLUON_TOL,
                                   atol=GLUON_TOL, err_msg=k)
    _assert_bitwise(got, _gluon_run(mt, skip=3))


def test_nanguard_invalid_mode_rejected():
    with pytest.raises(ValueError, match="nanguard"):
        tconfig.set("resilience.nanguard", "explode")
    assert tres.nanguard_mode() == ""


# ------------------------------------------------------- the skip word
SKIP_SHAPES = [(7, 5), (33,), (4, 4, 3), (1,)]


@pytest.mark.parametrize("kernel", ["sgd", "adam"])
@pytest.mark.parametrize("word", [None, 0, 1])
def test_skip_word_plain_versions(kernel, word):
    """K1's and K3's plain versions with the skip word: None and 0 are
    bitwise the word-less call, 1 writes no byte (masters, state,
    casts)."""
    rng = np.random.RandomState(11)

    def tensors():
        return [torch.from_numpy(rng.randn(*s).astype("f4"))
                for s in SKIP_SHAPES]
    ws, gs, ms, vs = tensors(), tensors(), tensors(), \
        [t.abs() for t in tensors()]
    outs = [torch.zeros(s, dtype=torch.bfloat16) for s in SKIP_SHAPES]
    skip = None if word is None else torch.tensor(word, dtype=torch.int32)
    n = len(ws)

    def call(w, m, v, o, skip):
        if kernel == "sgd":
            ck.fused_sgd_step_multi(w, gs, m, [0.1] * n, [1e-4] * n, 0.9,
                                    outs=o, skip=skip)
        else:
            ck.fused_adam_step_multi(w, gs, m, v, [1e-3] * n, [0.0] * n,
                                     0.9, 0.999, 1e-8, outs=o, skip=skip)

    def copies():
        return ([t.clone() for t in ws], [t.clone() for t in ms],
                [t.clone() for t in vs], [t.clone() for t in outs])
    want = copies()
    call(*want, None)
    got = copies()
    call(*got, skip)
    orig = (ws, ms, vs, outs)
    for g, w, o in zip(got, want, orig):
        for a, b, c in zip(g, w, o):
            expect = c if word == 1 else b
            assert a.view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32).equal(expect.view(
                              torch.int16 if a.dtype == torch.bfloat16
                              else torch.int32))


def test_skip_word_finds_each_kind_of_non_finite():
    """``skip_word`` over mixed f32/bf16 lists: 0 when finite (every bit
    kept), 1 for a NaN, a +Inf or a bf16 -Inf anywhere."""
    rng = np.random.RandomState(2)
    base = [torch.from_numpy(rng.randn(5, 3).astype("f4")),
            torch.from_numpy(rng.randn(17).astype("f4")).bfloat16(),
            torch.tensor(1.5)]
    keep = [t.clone() for t in base]
    assert int(tres.skip_word(base, {"x": None})) == 0
    assert all(a.equal(b) for a, b in zip(base, keep))
    for i, pos, val in ((0, 7, float("nan")), (1, 16, float("-inf")),
                        (2, 0, float("inf"))):
        bad = [t.clone() for t in base]
        bad[i].view(-1)[pos] = val
        assert int(tres.skip_word(bad)) == 1
        assert not bool(tres.all_finite(bad))
    ints = [torch.arange(4)]
    assert int(tres.skip_word(ints)) == 0


def test_watch_streak_drains_in_order():
    z = torch.zeros((), dtype=torch.int32)
    streak = z
    for finite in (True, False, False, True, False):
        streak = tres.guarded_streak(torch.tensor(finite), streak)
        tres.watch_streak("w", streak)
    tres.poll_streaks("w", block=True)
    assert tres.nonfinite_stats("w") == {"streak": 1, "total": 3}
    assert not tres._STREAK_PENDING.get("w")


# ------------------------------------------ manifests across the packages
def _ref_spmd_checkpoint(tmp_path):
    jtr, _ = _spmd_pair("sgd", SGD)
    for i in range(2):
        jtr.step(*_spmd_batch(i))
    mgr = jres.CheckpointManager(str(tmp_path / "ref"), every_n_steps=2)
    path = mgr.save(2, jtr.save_checkpoint)
    return jtr, mgr, path


def test_manifests_verify_across_packages(tmp_path):
    _, _, ref_path = _ref_spmd_checkpoint(tmp_path)
    man = tres.verify_checkpoint(ref_path, require_manifest=True)
    assert man["step"] == 2 and man["schema"] == tres.MANIFEST_SCHEMA
    _, tr = _spmd_pair("sgd", SGD)
    tr.step(*(torch.from_numpy(a) for a in _spmd_batch(0)))
    mgr = tres.CheckpointManager(str(tmp_path / "port"), every_n_steps=1)
    path = mgr.save(1, tr.save_checkpoint)
    assert jres.verify_checkpoint(path, require_manifest=True)["step"] == 1
    with open(path, "r+b") as f:
        f.truncate(64)
    for res in (jres, tres):
        with pytest.raises(res.CheckpointCorruptError, match="integrity"):
            res.verify_checkpoint(path)


def test_port_manager_restores_a_reference_checkpoint(tmp_path):
    jtr, _, ref_path = _ref_spmd_checkpoint(tmp_path)
    _, tr = _spmd_pair("sgd", SGD)
    resumed = tr.attach_checkpoint_manager(
        tres.CheckpointManager(os.path.dirname(ref_path)))
    assert resumed == 2 and tr._step_num == 2
    jtr.sync()
    tr.sync()
    jp = {n[len(jtr.block.prefix):]: p.data().asnumpy()
          for n, p in jtr.block.collect_params().items()}
    for n, p in tr.block.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      jp[n[len(tr.block.prefix):]])


# ----------------------------------------------------------- the manager
def _saver_of(payload):
    def save(path):
        with tres.atomic_write(path, "wb") as f:
            pickle.dump(payload, f)
    return save


def _load_into(seen):
    def load(path):
        try:
            with open(path, "rb") as f:
                seen.update(pickle.load(f))
        except (EOFError, pickle.UnpicklingError) as exc:
            raise tres.CheckpointCorruptError(str(exc)) from exc
    return load


def test_manager_retention_and_latest(tmp_path):
    mgr = tres.CheckpointManager(str(tmp_path), every_n_steps=2, keep=2)
    for step in range(1, 8):
        mgr.maybe_save(step, _saver_of({"step": step}))
    assert [s for s, _ in mgr.checkpoints()] == [4, 6]
    assert mgr.latest()[0] == 6
    assert tt.counter("resilience.ckpt_saves").value == 3
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_manager_restore_falls_back_past_truncated(tmp_path):
    mgr = tres.CheckpointManager(str(tmp_path), every_n_steps=1, keep=3)
    for step in (1, 2, 3):
        mgr.save(step, _saver_of({"step": step}))
    with open(mgr.path_for(3), "r+b") as f:
        f.truncate(5)
    seen = {}
    assert mgr.restore(_load_into(seen)) == 2 and seen["step"] == 2
    assert mgr.latest()[0] == 2
    assert tt.counter("resilience.ckpt_fallbacks").value == 1


def test_ckpt_write_fault_keeps_previous_loadable(tmp_path):
    """A writer dying mid-checkpoint (the ckpt_write fault, no retry)
    leaves the previous file whole and loadable, and no temp file."""
    tconfig.set("resilience.retry_attempts", 1)
    _, tr = _spmd_pair("sgd", SGD)
    tr.step(*(torch.from_numpy(a) for a in _spmd_batch(0)))
    path = str(tmp_path / "only.ckpt")
    tr.save_checkpoint(path)
    before = open(path, "rb").read()
    tr.step(*(torch.from_numpy(a) for a in _spmd_batch(1)))
    tconfig.set("resilience.faults", "ckpt_write:1")
    with pytest.raises(OSError, match="ckpt_write"):
        tr.save_checkpoint(path)
    tconfig.set("resilience.faults", "")
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["only.ckpt"]
    _, tr2 = _spmd_pair("sgd", SGD)
    assert tr2.load_checkpoint(path) == 1


def test_manager_retries_a_ckpt_write_fault(tmp_path):
    tconfig.set("resilience.faults", "ckpt_write:1@step=1")
    mgr = tres.CheckpointManager(str(tmp_path), every_n_steps=1)
    mgr.save(1, _saver_of({"step": 1}))
    assert tt.counter("resilience.retries.ckpt_write").value == 1
    assert tres.verify_checkpoint(mgr.path_for(1), require_manifest=True)


def test_sigterm_preemption_saves_and_resumes_bitwise(tmp_path):
    """SIGTERM before step 4: the step finishes, the manager checkpoints
    it and the loop exits 0; a new trainer resumes from it, and its tail
    is bitwise the uninterrupted run's."""
    steps = 6
    batches = [tuple(torch.from_numpy(a) for a in _spmd_batch(i))
               for i in range(steps)]
    _, base = _spmd_pair("sgd", SGD)
    base_losses = [float(base.step(*b)) for b in batches]
    tconfig.set("resilience.on_preempt", "save_and_exit")
    _, tr = _spmd_pair("sgd", SGD)
    mgr = tres.CheckpointManager(str(tmp_path), every_n_steps=2)
    assert tr.attach_checkpoint_manager(mgr) is None
    with pytest.raises(SystemExit) as exc:
        for i, b in enumerate(batches):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            tr.step(*b)
    assert exc.value.code == 0
    assert tt.counter("resilience.preemptions").value == 1
    assert mgr.latest()[0] == 4
    tconfig.set("resilience.on_preempt", "")
    _, tr2 = _spmd_pair("sgd", SGD)
    assert tr2.attach_checkpoint_manager(
        tres.CheckpointManager(str(tmp_path), every_n_steps=2)) == 4
    tail = [float(tr2.step(*b)) for b in batches[4:]]
    assert tail == base_losses[4:]
    _assert_bitwise(_state(tr2), _state(base))


def test_preemption_knob_off_clears_pending_request():
    tconfig.set("resilience.on_preempt", "save_and_exit")
    os.kill(os.getpid(), signal.SIGTERM)
    assert tres.preempt_requested()
    tconfig.set("resilience.on_preempt", "")
    assert not tres.preempt_requested()
    assert signal.getsignal(signal.SIGTERM) is not tres._on_preempt_signal


def test_gluon_preemption_save(tmp_path):
    saved = []
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tr.set_preemption_save(lambda: saved.append(1))
    with mt.autograd.record():
        loss = net(mt.nd.ones((4, 3))).sum()
    loss.backward()
    tres.request_preempt()
    with pytest.raises(SystemExit) as exc:
        tr.step(4)
    assert exc.value.code == 0 and saved == [1]


def test_module_fit_exits_on_preemption(tmp_path):
    X = np.random.RandomState(0).randn(32, 6).astype("f4")
    Y = np.zeros(32, "f4")
    data = mt.sym.Variable("data")
    out = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=2,
                                                     name="fc"),
                               name="softmax")
    mod = mt.mod.Module(out, context=mt.cpu())
    prefix = str(tmp_path / "m")
    tres.request_preempt()
    with pytest.raises(SystemExit) as exc:
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=8), num_epoch=2,
                epoch_end_callback=mt.callback.do_checkpoint(prefix))
    assert exc.value.code == 0
    assert os.path.exists(prefix + "-0001.params")


# ------------------------------------------------- retried fault kinds
def test_io_fault_retried_with_counters():
    X = np.arange(48, dtype="f4").reshape(12, 4)
    plain = [b.data[0].asnumpy() for b in mt.io.NDArrayIter(X,
                                                             batch_size=4)]
    tconfig.set("resilience.faults", "io:0.5")
    tconfig.set("resilience.retry_attempts", 8)
    faulted = [b.data[0].asnumpy() for b in mt.io.NDArrayIter(X,
                                                               batch_size=4)]
    assert all(np.array_equal(a, b) for a, b in zip(plain, faulted))
    assert len(plain) == len(faulted) == 3
    retries = tt.counter("resilience.retries.io").value
    assert retries > 0
    assert tt.counter("resilience.injected.io").value == retries


def test_kvstore_fault_retried_with_counters():
    tconfig.set("resilience.faults", "kvstore:2@step=1")
    kv = mt.kv.create("local")
    kv.init(3, mt.nd.zeros((2, 2)))
    kv.push(3, mt.nd.ones((2, 2)) * 2)
    out = mt.nd.zeros((2, 2))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 2, "f4"))
    assert tt.counter("resilience.retries.kvstore").value == 2
    assert tt.counter("resilience.retries").value == 2


def test_poison_batch_kinds():
    assert np.isnan(tres.poison_batch(np.ones((2, 2), "f4"))).all()
    assert tres.poison_batch(np.ones(3, "i4")).dtype == np.int32
    t = tres.poison_batch(torch.ones(2))
    assert isinstance(t, torch.Tensor) and torch.isnan(t).all()
    nd = tres.poison_batch(mt.nd.ones((2,)))
    assert isinstance(nd, mt.nd.NDArray) and np.isnan(nd.asnumpy()).all()
    ids = torch.arange(3)
    assert tres.poison_batch(ids) is ids


# ------------------------------------------------------------- the abort
def test_spmd_abort_raises_and_checkpoints_last_good(tmp_path):
    tconfig.set("resilience.nanguard", "abort")
    tconfig.set("resilience.faults", "nan:1@step=2")
    _, tr = _spmd_pair("sgd", SGD)
    mgr = tres.CheckpointManager(str(tmp_path))
    tr.attach_checkpoint_manager(mgr, auto_resume=False)
    good = None
    with pytest.raises(tres.NonFiniteStepError, match="non-finite"):
        for i in range(5):
            tr.step(*(torch.from_numpy(a) for a in _spmd_batch(i)))
            if i == 0:
                good = _state(tr)
            tres.poll_streaks(block=True)
    step, path = mgr.latest()
    assert step == 2
    _, tr2 = _spmd_pair("sgd", SGD)
    tr2.load_checkpoint(path)
    _assert_bitwise(good, _state(tr2))


def test_skip_mode_aborts_after_patience():
    tconfig.set("resilience.nanguard", "skip")
    tconfig.set("resilience.nanguard_patience", 2)
    tconfig.set("resilience.faults", "nan:3@step=2")
    try:
        _, tr = _spmd_pair("sgd", SGD)
        raised = None
        for i in range(6):
            try:
                tr.step(*(torch.from_numpy(a) for a in _spmd_batch(i)))
            except tres.NonFiniteStepError:
                raised = i + 1
                break
            tres.poll_streaks(block=True)
        assert raised == 4  # bad steps 2 and 3 reach the patience
    finally:
        tconfig.unset("resilience.nanguard_patience")


def test_gluon_abort_saves_through_preemption_save():
    tconfig.set("resilience.nanguard", "abort")
    saved = []
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tr.set_preemption_save(lambda: saved.append(1))
    for x in (np.nan, 1.0):
        with mt.autograd.record():
            loss = net(mt.nd.ones((4, 3)) * x).sum()
        loss.backward()
        if np.isnan(x):
            tr.step(4)
            continue
        with pytest.raises(tres.NonFiniteStepError):
            tr.step(4)
    assert saved == [1]
