"""Multi-rank scale-out of the port on the CPU: 2 and 3 gloo ranks started
by the port's launcher (``python -m mxnet_tpu_torch.launch``), each
running tests/torch_dist_worker.py, held against the reference on a 2- or
3-device CPU mesh computed here (the workers never import JAX).

- The dist_sync contract of tests/dist_worker.py (value-exact sums,
  pushpull, ``host_allreduce``, ``row_sparse_pull``, 2-bit compression
  with error feedback) and ``gluon.Trainer`` over ``dist_sync`` with
  ``compression_params``: asserted inside the workers.
- The vocab-sharded lookup: bitwise the one-rank lookup on every rank,
  and the reference's lookup of the whole table; ``ShardedEmbedding``
  over the ranks bitwise a rank-local one (lookups, SGD updates);
  ``shard_batch`` gives each rank its rows.
- 3 ``SPMDTrainer`` steps of the DLRM-style model on ``{"dp": n}`` (the
  second pad-masked), row-sparse SGD (table sharded when the rank count
  divides the vocab, else whole on every rank), dense SGD and row-sparse
  Adam, against the reference's data-parallel step: losses within 2e-7
  and parameters within 1e-7 (SGD) or 1e-6 (Adam, whose bias correction
  the port takes in Python floats and the reference's traced step in
  f32) absolute; every rank's parameters bitwise alike; a checkpoint
  (the sharded table gathered, rank 0 writing) restores every rank's
  shard and optimizer state bitwise.
- 3 compressed steps on ``{"dcn": n}`` against the reference's DCN hop
  rebuilt from its codec and gradients (``_ref_dcn``): with dyadic inputs
  every sum is exact, so residuals, losses and parameters are bitwise the
  reference's; with random inputs within 1e-6.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

import mxnet_tpu as ref
import mxnet_tpu.name  # noqa: F401
import mxnet_tpu_torch as mt
from mxnet_tpu.parallel import SPMDTrainer as RefTrainer
from mxnet_tpu.parallel import embedding as ref_emb
from mxnet_tpu.parallel import make_mesh as ref_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402
from _torch_dcn_ref import dcn_inputs, ref_dcn as _ref_dcn  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
ROUTES = (("sparse", "sgd"), ("dense", "sgd"), ("sparse", "adam"))
PARAM_ATOL = {"sgd": 1e-7, "adam": 1e-6}
LOSS_ATOL = 2e-7
DCN_RANDOM_ATOL = 1e-6


def _strip(name):
    return name.split("_", 1)[1]


def _launch(n, workdir, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
         sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         str(workdir)],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)


def _ref_net(make):
    with ref.name.NameManager():
        net = make(ref)
    ref.random.seed(7)
    net.initialize(ref.init.Xavier())
    return net


def _inputs(n):
    ids, labels, pads = W.global_batches(n)
    out = {"pads": np.array(pads)}
    for s in range(W.STEPS):
        out["ids%d" % s], out["labels%d" % s] = ids[s], labels[s]
    net = _ref_net(W.dlrm_net)
    for name, p in net.collect_params().items():
        out["init/" + name] = p.data().asnumpy()
    out.update(dcn_inputs(n))
    return out


def _ref_train(n, inputs, sparse, opt):
    ref.config.set("embedding.sharded", sparse)
    try:
        net = _ref_net(W.dlrm_net)
        optp = {"learning_rate": W.LR if opt == "sgd" else 0.01}
        tr = RefTrainer(net, ref.gluon.loss.L2Loss(), opt, optp,
                        mesh=ref_mesh({"dp": n}, jax.devices()[:n]))
        losses = [float(tr.step(inputs["ids%d" % s], inputs["labels%d" % s],
                                pad=int(inputs["pads"][s])))
                  for s in range(W.STEPS)]
        tr.sync()
    finally:
        ref.config.set("embedding.sharded", True)
    params = {_strip(k): p.data().asnumpy()
              for k, p in net.collect_params().items()}
    return np.array(losses, np.float32), params


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def world(request, tmp_path_factory):
    """One launch of ``n`` workers over every scenario, and the
    reference's results on an ``n``-device mesh."""
    n = request.param
    workdir = tmp_path_factory.mktemp("dist%d" % n)
    inputs = _inputs(n)
    np.savez(workdir / "inputs.npz", **inputs)
    proc = _launch(n, workdir)
    log = proc.stdout[-3000:] + proc.stderr[-6000:]
    return {"n": n, "dir": workdir, "inputs": inputs, "proc": proc,
            "log": log}


def _rank(world, r, tag):
    return dict(np.load(world["dir"] / ("rank%d_%s.npz" % (r, tag))))


def test_dist_sync_kvstore_value_exact(world):
    proc, n = world["proc"], world["n"]
    assert proc.returncode == 0, world["log"]
    for r in range(n):
        assert "WORKER_OK rank=%d/%d" % (r, n) in proc.stdout, world["log"]
    # the backend rule, printed once by each rank
    assert proc.stderr.count("backend gloo (ranks on the CPU)") == n


def test_sharded_lookup_bitwise(world):
    n = world["n"]
    for r in range(n):
        got = _rank(world, r, "lookup")
        want = np.asarray(ref_emb.lookup_unique(got["table"], got["uniq"]))
        # the reference's +0.0 for sentinel ids, the owner's bits (-0.0
        # included) for table rows
        assert got["rows"].tobytes() == want.tobytes()


@pytest.mark.parametrize("route,opt", ROUTES)
def test_data_parallel_step_matches_reference(world, route, opt):
    n, tag = world["n"], "%s_%s" % (route, opt)
    want_loss, want = _ref_train(n, world["inputs"], route == "sparse", opt)
    runs = [_rank(world, r, tag) for r in range(n)]
    for other in runs[1:]:
        for k in runs[0]:
            assert runs[0][k].tobytes() == other[k].tobytes(), k
    got = runs[0]
    assert all(bool(r["checkpoint_restored"]) for r in runs)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=0,
                               atol=LOSS_ATOL)
    for name, w in want.items():
        np.testing.assert_allclose(got["param/" + name], w, rtol=0,
                                   atol=PARAM_ATOL[opt], err_msg=name)
    if route == "sparse":
        rows = W.VOCAB // n if W.VOCAB % n == 0 else W.VOCAB
        assert tuple(got["shard/embedding0_weight"]) == (rows, W.DIM)
        touched = np.unique(np.concatenate(
            [world["inputs"]["ids%d" % s].ravel() for s in range(W.STEPS)]))
        untouched = np.setdiff1d(np.arange(W.VOCAB), touched)
        init = next(v for k, v in world["inputs"].items()
                    if k.endswith("embedding0_weight"))
        assert got["param/embedding0_weight"][untouched].tobytes() == \
            init[untouched].tobytes()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
def test_dcn_compressed_step_matches_reference(world, exact):
    n = world["n"]
    want = _ref_dcn(n, world["inputs"], exact)
    got = [_rank(world, r, "dcn_exact" if exact else "dcn_random")
           for r in range(n)]
    for s in range(W.STEPS):
        for name in ("weight", "bias"):
            res = np.stack([g["res%d/dense0_%s" % (s, name)] for g in got])
            ref_res = want["res%d/dense0_%s" % (s, name)]
            codes = got[0]["codes%d/dense0_%s" % (s, name)]
            assert set(np.unique(codes)) <= {-1, 0, 1}
            if exact:
                assert res.tobytes() == ref_res.tobytes(), (s, name)
            else:
                np.testing.assert_allclose(res, ref_res, rtol=0,
                                           atol=DCN_RANDOM_ATOL)
        loss = got[0]["loss%d" % s]
        if exact:
            assert loss.tobytes() == want["loss%d" % s].tobytes()
        else:
            np.testing.assert_allclose(loss, want["loss%d" % s], rtol=0,
                                       atol=DCN_RANDOM_ATOL)
    for name in ("weight", "bias"):
        key = "param/dense0_" + name
        for g in got[1:]:
            assert g[key].tobytes() == got[0][key].tobytes()
        if exact:
            assert got[0][key].tobytes() == want[key].tobytes()
        else:
            np.testing.assert_allclose(got[0][key], want[key], rtol=0,
                                       atol=DCN_RANDOM_ATOL)


def test_dist_worker_death_aborts_job_cleanly(tmp_path):
    """A rank that dies mid-job fails the whole launch promptly: the
    launcher ends the survivors instead of leaving them in a barrier."""
    t0 = time.time()
    proc = _launch(2, tmp_path, {"MXTPU_TEST_DIE_RANK": "1"})
    assert proc.returncode != 0
    assert "WORKER_DYING rank=1" in proc.stdout
    assert "WORKER_OK" not in proc.stdout
    assert time.time() - t0 < LAUNCH_TIMEOUT_S / 2


def test_mesh_over_two_devices_needs_a_group():
    with mt.cpu():
        with pytest.raises(RuntimeError, match="process group of 2 ranks"):
            mt.parallel.make_mesh({"dp": 2})
        mesh = mt.parallel.make_mesh({"dp": -1})
        assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"dp": 1})


def test_dist_async_warns_sync_semantics():
    with pytest.warns(UserWarning, match="SYNCHRONOUS"):
        kv = mt.kv.create("dist_async")
    assert (kv.type, kv.num_workers) == ("dist_async", 1)


def test_kvstore_server_role_exits_cleanly():
    env = dict(os.environ, DMLC_ROLE="server",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch; print('RAN')"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "RAN" not in proc.stdout
    assert "obsolete" in proc.stderr
