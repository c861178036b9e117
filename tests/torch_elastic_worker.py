"""One rank of tests/test_torch_elastic.py's elastic run (gloo on the CPU),
started by the port's elastic launcher (``python -m
mxnet_tpu_torch.launch -n 2 --elastic ...``).  Never imports JAX.

Generation 0: the uninterrupted two-rank run of ``STEPS`` steps (elastic
off), then the elastic run, where rank 1 draws ``peer_preempt`` at
``PEER_STEP`` and both ranks checkpoint (coordinated) and exit 0.
Generation 1: every rank resumes from that checkpoint and finishes; then
a sharded checkpoint round trip at tp=2 (and a load of it into a
one-rank trainer), a dist kvstore push under the ``dcn_push`` fault, and
the nanguard over two ranks: a skip word set on rank 1 alone at tp=2
skips the step on both ranks, and ``nanguard=abort`` stops both ranks at
one step with one checkpoint.  Each rank writes ``gen<g>_rank<r>.json``.
"""
import json
import os
import sys

import numpy as np
import torch

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.name  # noqa: F401
from mxnet_tpu_torch import config, elastic, resilience, telemetry
from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

STEPS, PEER_STEP, FEAT, WIDTH, CLASSES, BATCH = 8, 4, 6, 16, 3, 8
SHARD_STEPS = 2
GUARD_STEPS, GUARD_SKIP_STEP, ABORT_NAN_STEP = 3, 2, 2


def batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, FEAT).astype(np.float32),
             rng.randint(0, CLASSES, (BATCH,)).astype(np.float32))
            for _ in range(n)]


def mlp():
    nn = mx.gluon.nn
    with mx.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(WIDTH, activation="relu", in_units=FEAT))
            net.add(nn.Dense(WIDTH, activation="relu", in_units=WIDTH))
            net.add(nn.Dense(CLASSES, in_units=WIDTH))
    mx.random.seed(0)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net


def trainer(tp=False, mesh=None):
    net = mlp()
    specs = None
    if tp:
        specs = {net.prefix + "dense0_weight": ("tp", None),
                 net.prefix + "dense0_bias": ("tp",),
                 net.prefix + "dense1_weight": (None, "tp")}
    mesh = mesh or make_mesh({"tp": 2} if tp else {"dp": 2})
    return SPMDTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       mesh=mesh, param_specs=specs)


def bits(t):
    return t.detach().contiguous().view(torch.int32).numpy().tobytes()


def sharded(workdir):
    data = batches(2 * SHARD_STEPS, 7)
    path = os.path.join(workdir, "sharded")
    tr = trainer(tp=True)
    for x, y in data[:SHARD_STEPS]:
        tr.step(x, y)
    tr.save_checkpoint_sharded(path)
    whole = {n: tr._full(n).clone() for n in tr.params}
    cont = [tr.step(x, y) for x, y in data[SHARD_STEPS:]]
    again = trainer(tp=True)
    loaded = again.load_checkpoint_sharded(path)
    rep = [again.step(x, y) for x, y in data[SHARD_STEPS:]]
    differing = sum(bits(a) != bits(b) for a, b in zip(cont, rep))
    differing += sum(bits(tr.params[n]) != bits(again.params[n])
                     for n in tr.params)
    # the same directory into a one-rank trainer: each block lands in the
    # whole tensor
    one = trainer(mesh=make_mesh({"dp": 1}, [mx.cpu()]))
    one.load_checkpoint_sharded(path)
    resharded = sum(bits(one.params[n]) != bits(whole[n]) for n in whole)
    return {"loaded_step": loaded, "differing": differing,
            "resharded_differing": resharded,
            "files": sorted(os.listdir(path)),
            "local_shapes": {n: list(tr.params[n].shape) for n in tr.params}}


def dcn_push():
    config.set("resilience.faults", "dcn_push:1@step=1")
    config.set("resilience.retry_base_s", 0.001)
    try:
        kv = mx.kv.create("dist_sync")
        kv.init(0, mx.nd.zeros((3,)))
        kv.push(0, mx.nd.ones((3,)) * (kv.rank + 1))
        out = mx.nd.zeros((3,))
        kv.pull(0, out=out)
        return {"value": out.asnumpy().tolist(),
                "injected": telemetry.counter(
                    "resilience.injected.dcn_push").value,
                "retries": telemetry.counter(
                    "resilience.retries.kvstore").value}
    finally:
        config.set("resilience.faults", "")


def one_sided_skip(skip_ranks):
    """Full weights after ``GUARD_STEPS`` steps at tp=2 under
    ``nanguard=skip``, the skip word forced set at ``GUARD_SKIP_STEP`` on
    the ranks ``skip_ranks`` only (their gradient blocks non-finite)."""
    rank = mx.parallel.dist.rank()
    real, calls = resilience.skip_word, []

    def forced(*trees):
        word = real(*trees)
        calls.append(1)
        if len(calls) == GUARD_SKIP_STEP and rank in skip_ranks:
            word = torch.ones_like(word)
        return word

    resilience.skip_word = forced
    try:
        tr = trainer(tp=True)
        for x, y in batches(GUARD_STEPS, 11):
            tr.step(x, y)
        return {n: tr._full(n).clone() for n in tr.params}
    finally:
        resilience.skip_word = real


def guard(workdir):
    rank = mx.parallel.dist.rank()
    config.set("resilience.nanguard", "skip")
    try:
        one = one_sided_skip({1})
        both = one_sided_skip({0, 1})
        none = one_sided_skip(set())
        skip_differing = sum(bits(one[n]) != bits(both[n]) for n in one)
        skip_took_effect = sum(bits(both[n]) != bits(none[n]) for n in one)
        resilience.reset_nanguard()
        config.set("resilience.nanguard", "abort")
        config.set("resilience.faults", "nan:1@step=%d" % ABORT_NAN_STEP)
        # the abort's flight-recorder report lands beside the checkpoints
        config.set("tracing.watchdog_dir", workdir)
        tr = trainer()
        ckdir = os.path.join(workdir, "abort_ckpt")
        tr.attach_checkpoint_manager(
            resilience.CheckpointManager(ckdir, every_n_steps=0))
        aborted_at = None
        try:
            for x, y in batches(STEPS, 5):
                tr.step(x, y)
        except resilience.NonFiniteStepError:
            aborted_at = tr._step_num
        return {"skip_differing": skip_differing,
                "skip_took_effect": skip_took_effect,
                "aborted_at": aborted_at,
                "ckpts": sorted(n for n in os.listdir(ckdir)
                                if n.endswith(".ckpt")) if rank == 0
                else None}
    finally:
        config.unset("resilience.nanguard")
        config.set("resilience.faults", "")
        resilience.reset_nanguard()


def main(workdir):
    gen = elastic.generation()
    with mx.cpu():
        mx.parallel.initialize()
        rank = mx.parallel.dist.rank()
        data = batches(STEPS, 3)
        rec = {"rank": rank, "generation": gen}
        base_path = os.path.join(workdir, "base_rank%d.npz" % rank)
        if gen == 0:
            config.set("elastic.dir", "")
            tr = trainer()
            losses = [tr.step(x, y) for x, y in data]
            np.savez(base_path, losses=torch.stack(losses).numpy(),
                     **{n: v.detach().numpy() for n, v in tr.params.items()})
            config.unset("elastic.dir")
            if rank == 1:
                config.set("resilience.faults",
                           "peer_preempt:1@step=%d" % PEER_STEP)
        tr = trainer()
        rec["resumed_at"] = tr.attach_checkpoint_manager(
            resilience.CheckpointManager(
                os.path.join(elastic.state_dir(), "ckpt"), every_n_steps=0))
        start = rec["resumed_at"] or 0
        losses = []
        try:
            for x, y in data[start:]:
                losses.append(tr.step(x, y))
        except SystemExit as exc:
            rec.update({"exit_code": exc.code,
                        "exited_at_step": tr._step_num})
            write(workdir, gen, rank, rec)
            elastic.stop_heartbeat()
            return 0
        base = np.load(base_path)
        got = torch.stack(losses).numpy()
        rec["losses_differing"] = int(
            (got.view(np.int32) != base["losses"][start:].view(np.int32))
            .sum())
        rec["params_differing"] = int(sum(
            (tr.params[n].detach().numpy().view(np.int32)
             != base[n].view(np.int32)).sum() for n in tr.params))
        rec["sharded"] = sharded(workdir)
        rec["dcn_push"] = dcn_push()
        rec["guard"] = guard(workdir)
        write(workdir, gen, rank, rec)
    elastic.stop_heartbeat()
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def write(workdir, gen, rank, rec):
    with open(os.path.join(workdir, "gen%d_rank%d.json" % (gen, rank)),
              "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
