"""Inception v3 in the port against the reference's on the CPU at its
published widths and input (1000 classes, 3x299x299, batch 1): the same
parameter names, shapes and order, and the logits in inference and in
training mode (see ``tests/test_torch_zoo.py``)."""
import _torch_gluon as G


def test_inception_v3_matches_reference():
    G.zoo_check("inceptionv3", (1, 3, 299, 299))
