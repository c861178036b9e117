"""Device meshes (counterpart of ``mxnet_tpu.parallel.mesh``), for one
device.

``make_mesh({"dp": -1})`` names the devices a trainer runs on by axis.
The port runs on one card: a mesh over more than one device raises
``NotImplementedError`` (``torch.distributed`` meshes come with the
scale-out slice).  The default device is ``cuda:0``; pass
``devices=[torch.device("cpu")]`` (or ``[mx.cpu()]``) for the CPU.
"""
from __future__ import annotations

import math

from ..context import resolve_device

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh"]


class Mesh:
    """Named axes over devices: ``axis_names``, ``shape`` (name -> size),
    ``devices`` (flat list of ``torch.device``)."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def device(self):
        """The one device of a one-device mesh."""
        return self.devices[0]

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, [str(d) for d in self.devices])


def make_mesh(axes=None, devices=None):
    """A Mesh from ``{axis_name: size}``; one size may be -1 to absorb the
    remaining devices."""
    if axes is None:
        axes = {"dp": -1}
    devices = [resolve_device(d) for d in devices] if devices is not None \
        else [resolve_device(None)]
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    n_dev = len(devices)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n_dev % known:
            raise ValueError("Cannot infer -1 axis: %d devices, known=%d"
                             % (n_dev, known))
        sizes[sizes.index(-1)] = n_dev // known
    if math.prod(sizes) != n_dev:
        raise ValueError("Mesh %s does not cover %d devices"
                         % (dict(zip(names, sizes)), n_dev))
    if n_dev != 1:
        raise NotImplementedError(
            "meshes over %d devices are not ported: the port trains on one "
            "device" % n_dev)
    return Mesh(devices, names, sizes)


def data_parallel_mesh(devices=None):
    return make_mesh({"dp": -1}, devices)
