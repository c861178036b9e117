"""DenseNet-121 in the port against the reference's on the CPU at its
published widths (1000 classes), batch 1: the same parameter names,
shapes and order, and the logits in inference and in training mode (see
``tests/test_torch_zoo.py``).  Its last ``AvgPool2D(7)`` needs a 7x7
map: 224x224 in."""
import _torch_gluon as G


def test_densenet121_matches_reference():
    G.zoo_check("densenet121", (1, 3, 224, 224))
