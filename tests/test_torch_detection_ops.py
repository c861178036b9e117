"""The detection ops of the port (``ops/contrib.py``,
``ops/contrib_extra.py``) held against the reference's on the CPU.

* Every op at ``chip_smoke.det_cases``'s small shapes (the cases the card
  phase ssd(d) also runs), through the port's op registry and the
  reference's op function (jitted) from the same seeded numpy inputs,
  within ``chip_smoke.DET_RTOL`` (the bound the card is held to as
  well): bitwise for the IoU, the anchors, max pooling, matching and
  NMS; 2^-20 to 2^-12 of the output's largest value where an exp, log,
  sin or cos, a bilinear tap, a sum in another order or an integral
  image is on the way (each reason beside ``DET_RTOL``).
* NMS: the port's plain greedy scan gives the reference's ``box_nms`` and
  ``MultiBoxDetection`` outputs bitwise, in the cases of ties, invalid
  rows, ``topk``, ``force_suppress``, suppression across classes and
  IoUs exactly at the threshold (``det_cases``), and over random rows
  here.
* ``ROIPooling``'s gradient, the kernel routing (``kernels.box_nms``
  counts; tier off runs the plain version; a tensor that is neither on
  the CPU nor on a card raises, no fallback), and the kernel's domain.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the reference's ops)
from mxnet_tpu.ops.registry import _REGISTRY as REF_OPS

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, telemetry
from mxnet_tpu_torch.base import KernelUnsupportedError
from mxnet_tpu_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CASES = chip_smoke.det_cases(np)


def _ref(op, arrays, attrs):
    """The reference's op on the CPU, jitted: one program a case, as its
    own hybridized blocks run it."""
    outs = jax.jit(lambda *xs: REF_OPS[op].fn(*xs, **attrs))(*arrays)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [np.asarray(o) for o in outs]


def _port(op, arrays, attrs):
    return chip_smoke.run_det_op(mt, op, arrays, attrs, mt.cpu())


@pytest.mark.parametrize("case", CASES, ids=["%s-%s" % (c[1], c[0])
                                             for c in CASES])
def test_op_matches_reference(case):
    label, op, arrays, attrs = case
    ratio, differing = chip_smoke.det_compare(
        np, op, _port(op, arrays, attrs), _ref(op, arrays, attrs))
    assert differing == 0 and ratio <= 1.0, (label, ratio, differing)


def test_every_detection_op_has_a_case():
    ops = {c[1] for c in CASES}
    assert ops == set(chip_smoke.DET_RTOL)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_plain_nms_is_the_references_scan_bitwise(seed):
    """Random rows, many overlapping, every option at once: the whole
    output (order, kept scores, suppressed -1) bitwise.  Seed 4 takes a
    negative threshold, under which rows of other classes suppress too
    (their IoU counts as 0), and a NaN class id."""
    rng = np.random.RandomState(seed)
    rows = chip_smoke._nms_rows(np, rng, 2, 80, classes=2, levels=16)
    attrs = {"overlap_thresh": float(rng.uniform(0.2, 0.6)),
             "valid_thresh": 0.1, "topk": 40 + seed,
             "id_index": 0 if seed % 2 else -1,
             "force_suppress": seed == 3}
    if seed == 4:
        rows[:, 5, 0] = np.nan
        attrs.update(overlap_thresh=-0.25, id_index=0, topk=-1)
    got, want = _port("box_nms", [rows], attrs), _ref("box_nms", [rows],
                                                      attrs)
    np.testing.assert_array_equal(got[0], want[0])


def test_roi_pooling_gradient_matches_reference():
    label, op, arrays, attrs = next(c for c in CASES if c[1] == "ROIPooling")
    head = np.random.RandomState(5).randn(4, 4, 3, 3).astype(np.float32)
    with mt.cpu():
        x = mt.nd.array(arrays[0])
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.ROIPooling(x, mt.nd.array(arrays[1]), **attrs)
        y.backward(mt.nd.array(head))
    ry, vjp = jax.vjp(jax.jit(lambda d: REF_OPS[op].fn(d, arrays[1],
                                                      **attrs)), arrays[0])
    np.testing.assert_array_equal(y.asnumpy(), np.asarray(ry))
    np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(vjp(head)[0]),
                               rtol=1e-6, atol=1e-6)


def _sorted_rows(n=64, seed=0):
    rng = np.random.RandomState(seed)
    coords = torch.from_numpy(chip_smoke._det_boxes(np, rng, n))[None]
    cls = torch.from_numpy(rng.randint(0, 3, (1, n)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(1, n) > 0.2)
    return coords, cls, valid


def test_routing_counts_and_tier_off_runs_the_plain_version(monkeypatch):
    coords, cls, valid = _sorted_rows()
    plain = ck.box_nms_sorted_plain(coords, cls, valid, 0.4)
    telemetry.reset()
    assert torch.equal(mt.kernels.box_nms(coords, cls, valid, 0.4), plain)
    assert telemetry.counter("kernels.box_nms").value == 1
    monkeypatch.setattr(ck, "box_nms_sorted", None)   # tier off: unused
    config.set("kernels.enabled", False)
    try:
        assert torch.equal(mt.kernels.box_nms(coords, cls, valid, 0.4),
                           plain)
    finally:
        config.unset("kernels.enabled")
    assert telemetry.counter("kernels.box_nms").value == 1


def test_a_tensor_off_the_cpu_goes_to_the_kernel_or_raises():
    coords, cls, valid = (t.to("meta") for t in _sorted_rows())
    before = ck.LAUNCHES["box_nms"]
    with pytest.raises(KernelUnsupportedError, match="CUDA"):
        ck.box_nms_sorted(coords, cls, valid, 0.5)
    assert ck.LAUNCHES["box_nms"] == before


def test_kernel_domain():
    coords, cls, valid = _sorted_rows()
    assert ck.box_nms_unsupported_reason(coords, cls, valid) is None
    assert ck.box_nms_unsupported_reason(coords, None, valid) is None
    assert "f32" in ck.box_nms_unsupported_reason(coords.double(), cls,
                                                  valid)
    assert "class ids" in ck.box_nms_unsupported_reason(coords, cls.long(),
                                                        valid)
    assert "valid" in ck.box_nms_unsupported_reason(coords, cls,
                                                    valid.float())
    big = torch.empty((1, ck.NMS_MAX_ROWS + 1, 4), device="meta")
    assert "rows" in ck.box_nms_unsupported_reason(
        big, None, torch.empty((1, ck.NMS_MAX_ROWS + 1), dtype=torch.bool,
                               device="meta"))
