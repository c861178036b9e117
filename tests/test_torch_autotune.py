"""``mx.autotune`` on the CPU: the cache file's round trip at the
reference's ``CACHE_VERSION``, the key and its fingerprint, a corrupt
file, the config-epoch memo, winners injected into the file applied (K4's
keys per split, K1's and K3's chunk), the knob's validation, the stack
sweep measured here, and a kernel search refused here with its reason."""
import json
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu.autotune as rat
import mxnet_tpu.runtime as rrt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autotune, config, kernels, runtime, telemetry
from mxnet_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(autouse=True)
def _cache(tmp_path):
    config.set("perf.autotune_cache", str(tmp_path / "autotune.json"))
    autotune.reset()
    telemetry.reset()
    yield tmp_path / "autotune.json"
    for k in ("perf.autotune", "perf.autotune_cache", "kernels.enabled",
              "runtime.stack_mode", "runtime.remat", "bn_two_pass_stats"):
        config.unset(k)
    autotune.reset()


def _key(family, site, dtype):
    return "|".join((family, site, "cpu", dtype,
                     autotune.config_fingerprint()))


def test_cache_round_trip_and_key(_cache):
    assert autotune.CACHE_VERSION == rat.CACHE_VERSION
    assert autotune.mode() == "auto" and autotune.enabled()
    assert autotune.cache_path() == str(_cache)
    assert autotune.config_fingerprint() == "kernels=1"
    g0 = autotune.generation()
    entry = {"impl": "paged", "keys_per_split": 256}
    autotune.record("paged", "paged/bh96/k2048/d64/quant=0", "bfloat16",
                    entry)
    assert autotune.generation() == g0 + 1
    raw = json.loads(_cache.read_text())
    assert raw["version"] == autotune.CACHE_VERSION
    assert raw["entries"] == {_key("paged", "paged/bh96/k2048/d64/quant=0",
                                   "bfloat16"): entry}
    # a fresh process's view: the entry from the file
    autotune.reset()
    got = autotune.lookup("paged", "paged/bh96/k2048/d64/quant=0",
                          "bfloat16")
    assert got == entry
    assert autotune.lookup("paged", "paged/other", "bfloat16") is None
    c = telemetry.snapshot()["counters"]
    assert c["autotune.cache_hit"] == 1 and c["autotune.cache_miss"] == 1
    assert autotune.export_entries()["applied"] == {
        _key("paged", "paged/bh96/k2048/d64/quant=0", "bfloat16"): entry}


def test_corrupt_file_reads_as_empty_and_warns_once(_cache):
    _cache.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt autotune cache"):
        assert autotune.lookup("paged", "s", "bfloat16") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        autotune.reset_memo()
        assert autotune.lookup("paged", "s2", "bfloat16") is None
    _cache.write_text(json.dumps({"version": 99, "entries": {}}))
    autotune.reset()
    with pytest.warns(RuntimeWarning):
        assert autotune.lookup("paged", "s", "bfloat16") is None
    assert telemetry.snapshot()["counters"]["autotune.cache_invalid"] == 2
    # recording over a corrupt file writes a good one
    autotune.record("stack", "default", "-", {"knobs": {}})
    assert json.loads(_cache.read_text())["version"] == 1


def test_epoch_memo_and_fingerprint(_cache):
    """A pick is memoized per config epoch; the fingerprint holds the
    kernel tier, so turning it off hides the winners recorded with it on
    and turning it back shows them."""
    autotune.record("paged", "site", "bfloat16", {"keys_per_split": 128})
    assert autotune.lookup("paged", "site", "bfloat16") is not None
    config.set("kernels.enabled", False)
    assert autotune.config_fingerprint() == "kernels=0"
    assert autotune.lookup("paged", "site", "bfloat16") is None
    config.unset("kernels.enabled")
    assert autotune.lookup("paged", "site", "bfloat16")["keys_per_split"] \
        == 128
    # a negative memo holds within an epoch, a knob change drops it
    assert autotune.lookup("paged", "late", "bfloat16") is None
    raw = json.loads(_cache.read_text())
    raw["entries"][_key("paged", "late", "bfloat16")] = {"keys_per_split": 64}
    _cache.write_text(json.dumps(raw))
    autotune._ENTRIES[0] = None   # the file re-read, the memo kept
    assert autotune.lookup("paged", "late", "bfloat16") is None
    config.set("bn_two_pass_stats", True)   # any knob: a new epoch
    assert autotune.lookup("paged", "late", "bfloat16") == \
        {"keys_per_split": 64}


def test_injected_winners_are_applied(_cache):
    """Winners written into the file as a search would write them: K4's
    keys per split reach ``paged_splits`` at that site only, and K1's and
    K3's chunk reach the launch table an optimizer makes for a tensor list
    of the searched shapes only (``fused_step_enabled`` reads no pick and
    sets no state); off reads nothing."""
    sgd = mt.optimizer.SGD(momentum=0.9)
    adam = mt.optimizer.Adam()
    shapes = [(40000,), (10,)]
    _cache.write_text(json.dumps({"version": 1, "entries": {
        _key("paged", "paged/bh96/k2048/d64/quant=0", "bfloat16"):
            {"impl": "paged", "keys_per_split": 512},
        _key("fused_step", autotune._fused_site("sgd/mom", shapes),
             "float32"): {"impl": "fused", "chunk": 16384},
        _key("fused_step", autotune._fused_site("adam", shapes),
             "float32"): {"impl": "fused", "chunk": 4096}}}))
    assert autotune.paged_pick((8, 12, 1, 64), 2048, "bfloat16", False) \
        == 512
    assert autotune.paged_pick((8, 12, 1, 64), 1024, "bfloat16", False) \
        is None
    assert autotune.paged_pick((8, 12, 1, 64), 2048, "bfloat16", True) \
        is None
    assert ck.paged_splits(96, 2048, 512) == (512, 4)
    assert ck.paged_splits(96, 2048) == (384, 6)
    assert kernels.fused_step_enabled(sgd) and kernels.fused_step_enabled(
        adam)
    assert autotune.fused_step_pick(sgd, shapes) == 16384
    assert autotune.fused_step_pick(adam, shapes) == 4096
    assert autotune.fused_step_pick(sgd, shapes[::-1]) is None
    ws = [torch.zeros(s) for s in shapes]
    table = sgd._table_of(ws)
    assert table.chunk == 16384 and adam._table_of(ws).chunk == 4096
    assert sgd._table_of(ws) is table
    cols = (ws, [torch.zeros_like(w) for w in ws], [None, None])
    host, blocks = table.write(ck.SGD_LAYOUT, cols, ws, [0.1, 0.1],
                               [0.0, 0.0])
    assert table.launch_chunk == 16384 and blocks == 3 + 1
    assert list(host["block0"]) == [0, 3]
    # another list keeps the fixed rule
    other = [torch.zeros(8)]
    assert sgd._table_of(other).chunk is None
    _, blocks = ck.LaunchTable().write(ck.SGD_LAYOUT, cols, ws, [0.1, 0.1],
                                       [0.0, 0.0])
    assert blocks == 5 + 1
    # the plain route updates as before (the chunk is a launch parameter)
    w = [torch.ones(8)]
    sgd.step_fused_multi(w, [torch.ones(8)], [torch.zeros(8)], [0.5],
                         [0.0], 1)
    assert torch.equal(w[0], torch.full((8,), 0.5))
    config.set("perf.autotune", "off")
    assert autotune.paged_pick((8, 12, 1, 64), 2048, "bfloat16",
                               False) is None
    assert autotune.fused_step_pick(sgd, shapes) is None
    assert mt.optimizer.SGD(momentum=0.9)._table_of(ws).chunk is None
    assert kernels.fused_step_enabled(sgd)


def test_knob_validation_reverts():
    config.set("perf.autotune", "measure")
    with pytest.raises(ValueError, match="perf.autotune"):
        config.set("perf.autotune", "sometimes")
    assert config.get("perf.autotune") == "measure"
    config.unset("perf.autotune")
    with pytest.raises(ValueError):
        config.set("perf.autotune", "on")
    assert config.get("perf.autotune") == "auto"
    assert config.source("perf.autotune") == "default"


def test_stack_search_runs_here_and_is_applied(_cache):
    """``search_stack`` measures every (stack_mode, remat) pair of the
    reference's grid on a small step, puts the knobs back, and
    ``runtime.stack_tuning`` applies the winner while both knobs sit at
    their defaults; an explicit knob wins."""
    x = torch.randn(16, 32)
    w = torch.randn(32, 32, requires_grad=True)

    def make_fn():
        def step(x):
            xs = {"w": torch.stack([w, w])}
            carry, _ = runtime.scan_stack(
                lambda c, p: (torch.tanh(c @ p["w"]), None), x, xs)
            carry.sum().backward()
        return step
    entry = autotune.search_stack(make_fn, (x,))
    assert set(entry["candidates"]) == {
        "remat=/stack_mode=scan", "remat=dots/stack_mode=scan",
        "remat=full/stack_mode=scan", "remat=/stack_mode=unroll"}
    assert config.source("runtime.stack_mode") == "default"
    assert config.source("runtime.remat") == "default"
    autotune.reset()
    pick = runtime.stack_tuning()
    assert pick == (entry["knobs"]["runtime.stack_mode"],
                    entry["knobs"]["runtime.remat"])
    config.set("runtime.remat", "full")
    assert runtime.stack_tuning()[1] == "full"
    assert [tuple(c) for c in runtime.stack_candidates()] == \
        [tuple(c) for c in rrt.stack_candidates()]


def test_kernel_search_is_refused_here():
    for call in (lambda: autotune.search_paged((8, 12, 1, 64),
                                               (8, 12, 2048, 64),
                                               "bfloat16", False),
                 lambda: autotune.search_fused(mt.optimizer.SGD()),
                 lambda: autotune.search_attention((1, 2, 64, 64),
                                                   (1, 2, 64, 64),
                                                   "bfloat16", True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # measure mode searches nothing on the CPU: the fixed rule applies
    config.set("perf.autotune", "measure")
    assert autotune.paged_pick((8, 12, 1, 64), 2048, "bfloat16",
                               False) is None
    q = torch.zeros(1, 2, 1, 16)
    pool = torch.zeros(4, 4, 2, 16)
    out = kernels.paged_attention_pool(
        q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
        torch.full((1,), 5, dtype=torch.int32))
    assert out.shape == q.shape and np.isfinite(out.numpy()).all()
