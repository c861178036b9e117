"""The port's ``mx.elastic`` and elastic launcher on the CPU, held against
the reference's contracts (``tests/test_elastic.py``).

- One process: the manifest's world stamp (each package verifies the
  other's), the coordinated manager's save and restore, the refusal of an
  unstamped snapshot, ``coordinate``, heartbeat expiry in flag mode (the
  lease scan called directly, so nothing waits on a clock) and
  ``os._exit(75)`` in abort mode, the ``peer_preempt`` agreement,
  elasticity off as a no-op, and ``launch_elastic``'s restart loop and
  budget exhaustion (its CLI too).
- Two gloo ranks through the elastic launcher (tests/torch_elastic_worker.py,
  one launch for every case): rank 1 draws ``peer_preempt`` and both
  ranks exit 0 at that step with one world-stamped checkpoint; the next
  generation resumes on both ranks at that step and ends bitwise equal
  to an uninterrupted two-rank run (losses and weights); a sharded
  checkpoint round trip at tp=2 is bitwise, each rank writing its own
  blocks, and loads whole into a one-rank trainer; a dist kvstore push
  under the ``dcn_push`` fault is retried to the exact sum; a skip word
  set on one rank at tp=2 skips the step on both, and ``nanguard=abort``
  stops both ranks at the same step (the streak read two steps behind)
  with one checkpoint.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu  # noqa: F401  (the reference package, for its manifests)
from mxnet_tpu import resilience as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, elastic, resilience, telemetry
from mxnet_tpu_torch.launch import launch_elastic
from mxnet_tpu_torch.parallel import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_elastic_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _reset():
    telemetry.reset()
    yield
    for knob in ("resilience.faults", "elastic.dir", "elastic.on_peer_loss"):
        config.unset(knob)
    resilience.clear_preempt()
    elastic.stop_heartbeat()


def _saver_of(payload):
    def save(path):
        import pickle
        with resilience.atomic_write(path, "wb") as f:
            pickle.dump(payload, f)
    return save


# ---------------------------------------------------- one process
def test_manifest_world_stamp_roundtrip(tmp_path):
    path = str(tmp_path / "x.ckpt")
    _saver_of({"step": 3})(path)
    world = {"process_count": 4, "mesh": {"dcn": 2, "dp": 2}}
    resilience.write_manifest(path, step=3, world=world)
    for res in (resilience, jres):
        assert res.verify_checkpoint(path, require_manifest=True)["world"] \
            == world


def test_coordinated_manager_save_restore(tmp_path):
    mesh = make_mesh({"dp": 1}, [mt.cpu()])
    mgr = elastic.CoordinatedCheckpointManager(
        str(tmp_path), every_n_steps=2, keep=2, mesh=mesh)
    seen = {}

    def load(path):
        import pickle
        with open(path, "rb") as f:
            seen.update(pickle.load(f))
    assert mgr.restore(load) is None
    for step in (2, 3, 4):
        mgr.maybe_save(step, _saver_of({"step": step}))
    assert mgr.restore(load) == 4 and seen["step"] == 4
    man = jres.verify_checkpoint(mgr.path_for(4), require_manifest=True)
    assert man["world"] == {"process_count": 1, "mesh": {"dp": 1}}
    assert [s for s, _ in mgr.checkpoints()] == [2, 4]


def test_restore_refuses_unstamped_snapshot(tmp_path):
    plain = resilience.CheckpointManager(str(tmp_path), every_n_steps=1,
                                         keep=3)
    plain.save(7, _saver_of({"step": 7}))
    coord = elastic.CoordinatedCheckpointManager(str(tmp_path),
                                                 every_n_steps=1, keep=3)
    assert coord.restore(lambda p: None) is None
    assert telemetry.counter("resilience.ckpt_fallbacks").value == 1
    coord.save(9, _saver_of({"step": 9}))
    assert coord.restore(lambda p: None) == 9


def test_coordinate_upgrades_plain_manager(tmp_path):
    plain = resilience.CheckpointManager(str(tmp_path), every_n_steps=5,
                                         keep=2, prefix="run")
    mesh = make_mesh({"dp": 1}, [mt.cpu()])
    up = elastic.coordinate(plain, mesh=mesh)
    assert isinstance(up, elastic.CoordinatedCheckpointManager)
    assert (up.directory, up.every_n_steps, up.keep, up.prefix) == \
        (plain.directory, 5, 2, "run")
    assert elastic.coordinate(up) is up and up.mesh is mesh


def _stale_lease(directory, rank):
    path = os.path.join(str(directory), "hb-r%d" % rank)
    with open(path, "w") as f:
        f.write("%d 0.0\n" % rank)
    old = time.time() - 60.0
    os.utime(path, (old, old))


def test_heartbeat_lease_expiry_flag_mode(tmp_path):
    config.set("elastic.on_peer_loss", "flag")
    hb = elastic.HeartbeatMonitor(str(tmp_path), rank=0, world=3,
                                  interval_s=0.05)
    _stale_lease(tmp_path, 1)          # rank 2 has no lease yet: not late
    hb.scan()
    assert set(hb.peer_lost()) == {1} and hb.peer_lost()[1] > hb.lease_s
    assert telemetry.counter("elastic.peer_lease_expired").value == 1
    hb.start()                          # writes its own lease at once
    hb.stop()
    assert os.path.exists(str(tmp_path / "hb-r0"))


def test_heartbeat_abort_mode_exits_75(tmp_path):
    _stale_lease(tmp_path, 1)
    code = ("from mxnet_tpu_torch import elastic; "
            "elastic.HeartbeatMonitor(%r, rank=0, world=2).scan(); "
            "print('survived')" % str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT, MXTPU_ELASTIC_ON_PEER_LOSS="abort")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == elastic.ABORT_EXIT_CODE == 75, proc.stderr
    assert "survived" not in proc.stdout


def test_peer_preempt_fault_triggers_agreement(tmp_path):
    config.set("elastic.dir", str(tmp_path))
    config.set("resilience.faults", "peer_preempt:1@step=3")
    assert not elastic.maybe_cluster_preempt(step=1)
    assert not elastic.maybe_cluster_preempt(step=2)
    assert not resilience.preempt_requested()
    assert elastic.maybe_cluster_preempt(step=3)
    assert resilience.preempt_requested() and elastic.preempt_announced()
    with open(str(tmp_path / "preempt-r0")) as f:
        payload = json.load(f)
    assert payload["step"] == 3 and payload["generation"] == 0
    elastic.announce_preempt(step=3)
    elastic.clear_flags()
    assert not elastic.preempt_announced()


def test_inactive_elastic_is_noop():
    assert not elastic.active()
    assert not elastic.maybe_cluster_preempt(step=1)
    assert elastic.ensure_heartbeat() is None
    with pytest.raises(ValueError, match="elastic.dir"):
        elastic.state_dir()


def test_launch_elastic_restart_loop(tmp_path):
    """A generation whose ranks drop preemption flags is started once
    more; the job ends 0 with no flag left."""
    runs = str(tmp_path / "runs.txt")
    worker = (
        "import os\n"
        "d = os.environ['MXTPU_ELASTIC_DIR']\n"
        "gen = os.environ['MXTPU_ELASTIC_GENERATION']\n"
        "rank = os.environ['MXTPU_PROCESS_ID']\n"
        "with open(%r, 'a') as f: f.write(gen + '-' + rank + chr(10))\n"
        "if gen == '0':\n"
        "    open(os.path.join(d, 'preempt-r' + rank), 'w').close()\n"
        % runs)
    rc = launch_elastic(2, [sys.executable, "-c", worker], max_restarts=2,
                        elastic_dir=str(tmp_path / "ed"))
    assert rc == 0
    with open(runs) as f:
        assert sorted(f.read().split()) == ["0-0", "0-1", "1-0", "1-1"]
    assert not [n for n in os.listdir(str(tmp_path / "ed"))
                if n.startswith("preempt-r")]


@pytest.mark.parametrize("how", ["function", "cli"])
def test_launch_elastic_budget_exhaustion(tmp_path, how):
    worker = ("import os\n"
              "d = os.environ['MXTPU_ELASTIC_DIR']\n"
              "rank = os.environ['MXTPU_PROCESS_ID']\n"
              "open(os.path.join(d, 'preempt-r' + rank), 'w').close()\n")
    cmd = [sys.executable, "-c", worker]
    edir = str(tmp_path / "ed")
    if how == "function":
        rc = launch_elastic(1, cmd, max_restarts=1, elastic_dir=edir)
    else:
        rc = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "1",
             "--elastic", "--max-restarts", "1", "--elastic-dir", edir]
            + cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, timeout=120).returncode
    assert rc != 0


def test_sharded_checkpoint_refusals(tmp_path):
    d = tmp_path / "not_a_ckpt"
    d.mkdir()
    (d / "keep.txt").write_text("user data")
    tr = W.trainer(mesh=make_mesh({"dp": 1}, [mt.cpu()]))
    for path in (str(d), str(tmp_path / "absent")):
        with pytest.raises(resilience.CheckpointCorruptError):
            tr.load_checkpoint_sharded(path)
    with pytest.raises(RuntimeError, match="no step"):
        tr.save_checkpoint_sharded(str(tmp_path / "early"))
    with mt.cpu():
        tr.step(*W.batches(1, 0)[0])
    with pytest.raises(ValueError, match="refusing"):
        tr.save_checkpoint_sharded(str(d))
    assert (d / "keep.txt").read_text() == "user data"


# -------------------------------------------------- two ranks, one launch
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("elastic")
    edir = str(workdir / "state")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         "--elastic", "--max-restarts", "1", "--elastic-dir", edir,
         sys.executable, os.path.join(ROOT, "tests",
                                      "torch_elastic_worker.py"),
         str(workdir)],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    recs = {}
    for gen in (0, 1):
        for r in (0, 1):
            with open(str(workdir / ("gen%d_rank%d.json" % (gen, r)))) as f:
                recs[gen, r] = json.load(f)
    return {"recs": recs, "edir": edir, "stderr": proc.stderr}


def test_peer_preemption_stops_both_ranks_at_one_step(run):
    for r in (0, 1):
        g0 = run["recs"][0, r]
        assert g0["exit_code"] == 0 and g0["exited_at_step"] == W.PEER_STEP
    assert run["stderr"].count("re-forming the world") == 1
    ckdir = os.path.join(run["edir"], "ckpt")
    ckpts = sorted(n for n in os.listdir(ckdir) if n.endswith(".ckpt"))
    assert ckpts == ["ckpt-%08d.ckpt" % W.PEER_STEP]
    man = resilience.verify_checkpoint(os.path.join(ckdir, ckpts[0]),
                                       require_manifest=True)
    assert man["world"] == {"process_count": 2, "mesh": {"dp": 2}}
    assert man["step"] == W.PEER_STEP


@pytest.mark.parametrize("rank", [0, 1])
def test_resumed_generation_is_bitwise_the_uninterrupted_run(run, rank):
    g1 = run["recs"][1, rank]
    assert g1["resumed_at"] == W.PEER_STEP
    assert g1["losses_differing"] == 0 and g1["params_differing"] == 0


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_checkpoint_round_trip_at_tp2(run, rank):
    sh = run["recs"][1, rank]["sharded"]
    assert sh["loaded_step"] == W.SHARD_STEPS
    assert sh["differing"] == 0 and sh["resharded_differing"] == 0
    # each rank wrote its own file of blocks
    assert [f for f in sh["files"] if f.endswith(".distcp")] == \
        ["__0_0.distcp", "__1_0.distcp"]
    assert sh["local_shapes"]["hybridsequential0_dense0_weight"] == \
        [W.WIDTH // 2, W.FEAT]


def test_dcn_push_fault_retried_over_ranks(run):
    for r in (0, 1):
        got = run["recs"][1, r]["dcn_push"]
        # the hop's fault is retried by push (kind kvstore) before any
        # value is applied: the sum is exact
        assert got["value"] == [3.0, 3.0, 3.0]
        assert got["injected"] == 1 and got["retries"] == 1


def test_one_ranks_skip_word_skips_every_rank(run):
    for r in (0, 1):
        got = run["recs"][1, r]["guard"]
        assert got["skip_took_effect"] > 0
        assert got["skip_differing"] == 0


def test_nanguard_abort_stops_both_ranks_at_one_step(run):
    at = [run["recs"][1, r]["guard"]["aborted_at"] for r in (0, 1)]
    # the crossing at ABORT_NAN_STEP is read two steps behind on every
    # rank, and the next step raises
    assert at == [W.ABORT_NAN_STEP + 2] * 2
    assert run["recs"][1, 0]["guard"]["ckpts"] == \
        ["ckpt-%08d.ckpt" % (W.ABORT_NAN_STEP + 2)]
