"""MobileNet v1 and v2 in the port against the reference's on the CPU
at their published widths (1000 classes), batch 2: the same parameter
names, shapes and order, and the logits in inference and in training
mode (see ``tests/test_torch_zoo.py``).  MobileNet takes any
input, but in training mode each BatchNorm normalises over its batch:
its last maps are kept at 4x4 (128x128 in), as the ResNet test keeps
its last stage (at 32x32 the last BatchNorms see two values each)."""
import pytest

import _torch_gluon as G


@pytest.mark.parametrize("name,shape", [
    ("mobilenet1.0", (2, 3, 128, 128)),
    ("mobilenet0.25", (2, 3, 128, 128)),
    ("mobilenetv2_1.0", (2, 3, 128, 128)),
    ("mobilenetv2_0.5", (2, 3, 128, 128)),
])
def test_zoo_family_matches_reference(name, shape):
    G.zoo_check(name, shape)
