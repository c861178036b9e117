"""Device meshes over ranks (counterpart of ``mxnet_tpu.parallel.mesh``).

The reference's mesh is one process over ``jax.devices()``; here it is
one process a device: a mesh over N devices needs an initialized process
group of world size N (:func:`parallel.initialize`), and rank ``r`` runs
on the mesh's device ``r``.  Ranks fill the axes in row-major order, as
the reference reshapes its device list.  ``make_mesh`` over several
devices but not one a rank raises: it never trains on fewer.  A
one-device mesh is rank-local (each rank computes alone on it).

Axis conventions are the reference's (:data:`AXES`): ``dp`` data
parallel, ``fsdp`` parameters sharded over the data-parallel ranks,
``tp`` tensor parallel (attention heads and MLP columns, Megatron's
splits), ``sp`` sequence parallel (ring attention), ``pp`` pipeline
stages, ``ep`` MoE experts, and ``dcn`` the slow cross-host hop
(gradient sync over it may be 2-bit compressed).  The collectives over
an axis are :mod:`.collectives`.

A batch means the same to every rank as in the reference: the GLOBAL
batch, split on its first axis over the batch axes (:func:`shard_batch`
returns this rank's rows).  The default device of a one-rank mesh is the
current context's (``cuda:0``); pass ``devices=[torch.device("cpu")]``
(or ``[mx.cpu()]``) for the CPU.
"""
from __future__ import annotations

import math

import torch

from ..context import resolve_device
from . import dist as _dist

__all__ = ["AXES", "Mesh", "make_mesh", "data_parallel_mesh", "sharding",
           "shard_batch", "replicated", "local_mesh_devices",
           "PartitionSpec", "NamedSharding"]

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep", "dcn")


class PartitionSpec(tuple):
    """Which mesh axes split each array axis (``None``: replicated); an
    entry may be a tuple of axes, split in that order."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class Mesh:
    """Named axes over ranks: ``axis_names``, ``shape`` (name -> size),
    ``devices`` (one ``torch.device`` a rank, in rank order), ``rank``
    (this process's) and ``device`` (this rank's)."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        # a one-device mesh is rank-local: each rank computes alone on it
        self.rank = _dist.rank() if len(self.devices) > 1 else 0
        self._groups = {}

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        """This rank's device."""
        return self.devices[self.rank]

    def coords(self, rank=None):
        """``{axis: index}`` of a rank (default: this one)."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, axis):
        return self.coords()[axis]

    def axis_size(self, axes):
        """The number of ranks along ``axes`` (a name or a tuple of
        them)."""
        return math.prod(self.shape[a] for a in _spec_axes(axes))

    def rank_of(self, coords):
        """The rank at ``{axis: index}`` (every axis named)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def members(self, axes, rank=None):
        """The ranks that differ from ``rank`` (default: this one) only
        along ``axes``, ascending: the members of :meth:`group`, in the
        order of their ranks in it."""
        c = self.coords(rank)
        fixed = [a for a in self.axis_names if a not in _spec_axes(axes)]
        return [r for r in range(self.size)
                if all(self.coords(r)[a] == c[a] for a in fixed)]

    def block_index(self, axes, rank=None):
        """The index of a rank's block when an array axis is split over
        ``axes`` in order (row-major over the named axes)."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (None: every rank).  Every rank must ask for the
        same ``axes`` at the same point of the program: the groups of one
        partition are created together, in one order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.size == 1 or all(self.shape[a] == 1 for a in self.axis_names
                                 if a not in axes):
            return None
        if axes not in self._groups:
            import torch.distributed as tdist
            members = {}
            for r in range(self.size):
                c = self.coords(r)
                key = tuple(c[a] for a in self.axis_names if a not in axes)
                members.setdefault(key, []).append(r)
            mine = None
            for key in sorted(members):
                g = tdist.new_group(members[key])
                if self.rank in members[key]:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self):
        return "Mesh(%s, rank %d of %s)" % (self.shape, self.rank,
                                           [str(d) for d in self.devices])


class NamedSharding:
    """An array's placement on a mesh: ``mesh`` and ``spec``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def device(self):
        return self.mesh.device

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def local_mesh_devices(n=None):
    """One device a rank: with a process group, ``cuda:(r % count)`` for
    each rank ``r`` on this rank's device type (the CPU when this rank
    runs there); without one, the current context's device."""
    world = _dist.world_size()
    if world == 1:
        devs = [resolve_device(None)]
    else:
        mine = _dist.device()
        if mine.type == "cpu":
            devs = [torch.device("cpu")] * world
        else:
            count = torch.cuda.device_count()
            devs = [torch.device("cuda", (r % _dist._GROUP.local_world)
                                 % count) for r in range(world)]
            devs[_dist.rank()] = mine
    if n is not None:
        if len(devs) < n:
            raise ValueError("Requested %d devices but only %d available"
                             % (n, len(devs)))
        devs = devs[:n]
    return devs


def make_mesh(axes=None, devices=None):
    """A Mesh from ``{axis_name: size}``; one size may be -1 to absorb the
    remaining devices.  Over more than one device it needs a process
    group whose world size is the device count; a one-device mesh is
    rank-local."""
    if axes is None:
        axes = {"dp": -1}
    devices = [resolve_device(d) for d in devices] if devices is not None \
        else local_mesh_devices()
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    n_dev = len(devices)
    world = _dist.world_size()
    if -1 not in sizes and math.prod(sizes) not in (1, world):
        raise RuntimeError(
            "a mesh over %d devices needs a process group of %d ranks (one "
            "process a device; this process's group has %d): start the "
            "ranks with `python -m mxnet_tpu_torch.launch -n %d ...`"
            % (math.prod(sizes), math.prod(sizes), world, math.prod(sizes)))
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n_dev % known:
            raise ValueError("Cannot infer -1 axis: %d devices, known=%d"
                             % (n_dev, known))
        sizes[sizes.index(-1)] = n_dev // known
    if math.prod(sizes) != n_dev:
        raise ValueError("Mesh %s does not cover %d devices"
                         % (dict(zip(names, sizes)), n_dev))
    if n_dev != 1 and n_dev != world:
        raise RuntimeError(
            "a mesh over %d devices needs a process group of %d ranks (one "
            "process a device; this process's group has %d): start the "
            "ranks with `python -m mxnet_tpu_torch.launch -n %d ...`"
            % (n_dev, n_dev, world, n_dev))
    return Mesh(devices, names, sizes)


def data_parallel_mesh(devices=None):
    return make_mesh({"dp": -1}, devices)


def sharding(mesh, *spec):
    return NamedSharding(mesh, PartitionSpec(*spec))


def _spec_axes(part):
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def _local_rows(mesh, x, axes):
    """This rank's block of ``x``'s first axis split over ``axes``."""
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return x
    rows = int(x.shape[0])
    if rows % n:
        raise ValueError("a batch of %d rows does not split over %s (%d "
                         "blocks)" % (rows, axes, n))
    b = rows // n
    i = mesh.block_index(axes)
    return x[i * b:(i + 1) * b]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch, axis="dp"):
    """This rank's rows of every array of ``batch`` (a tensor, numpy array,
    NDArray or a list / tuple / dict of them), the first axis split over
    ``axis`` (an axis name or a tuple of them), on the rank's device."""
    from ..ndarray.ndarray import NDArray
    axes = _spec_axes(axis)

    def one(x):
        if isinstance(x, NDArray):
            x = x._data
        return torch.as_tensor(_local_rows(mesh, x, axes)).to(mesh.device)
    return _tree_map(one, batch)


def replicated(mesh, tree):
    """Every array of ``tree`` whole on this rank's device."""
    from ..ndarray.ndarray import NDArray
    return _tree_map(lambda x: torch.as_tensor(
        x._data if isinstance(x, NDArray) else x).to(mesh.device), tree)
