"""SPMD training step (counterpart of ``mxnet_tpu.parallel.trainer``),
on one device.

The reference compiles the whole iteration — forward, backward, update —
into one jitted program over a mesh.  Here the step is the same sequence
in eager PyTorch on the mesh's one device: the f32 master weights (cast
to bf16 inside autograd under ``dtype="bfloat16"``) run the
functionalized forward and the loss, ``torch.autograd.grad`` gives the
f32 gradients of the masters, and the optimizer updates masters and
state in place (the analog of the reference's donation).  With the
kernel tier on and an optimizer with a fused step
(``kernels.fused_step_enabled``), the update of every trainable tensor
is one ``optimizer.step_fused_multi`` call: one launch of the
multi-tensor kernel over the whole list (K1, ``csrc/sgd_step.cu``, for
SGD; K3, ``csrc/adam_step.cu``, for Adam), whose launch table the
optimizer keeps across steps.  With the tier off it is
``optimizer.step`` per tensor.

What the reference has and the port refuses (``NotImplementedError``,
never silently ignored): meshes over several devices and sharded
``param_specs``; ``conv.weights_layout=HWIO``; the nanguard
(``resilience.nanguard``), in-step numerics capture
(``numerics.capture``) and 2-bit DCN gradient compression
(``kvstore.grad_compress``); sparse-gradient embeddings; pad-masked steps
(``step(pad>0)``); the checkpoint manager and checkpoint files.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import config as _config
from .. import kernels as _kernels
from ..ndarray.ndarray import NDArray, _wrap
from .functional import functionalize
from .mesh import data_parallel_mesh

__all__ = ["SPMDTrainer"]

# knobs of reference features the port does not have yet: set, they
# would change what a step computes, so the trainer refuses to run
_UNPORTED_KNOBS = {
    "resilience.nanguard": "the nanguard (non-finite step guard)",
    "numerics.capture": "in-step numerics capture",
    "kvstore.grad_compress": "compressed DCN gradient sync",
}


def _f32(x):
    """A Python float rounded to f32, as a Python float."""
    return float(_np.float32(x))


class SPMDTrainer:
    """Fused-step trainer for a Gluon block on a one-device mesh.

    Usage::

        trainer = SPMDTrainer(net, loss_fn, 'sgd',
                              {'learning_rate': 0.1, 'momentum': 0.9},
                              mesh=make_mesh({'dp': -1}))
        for data, label in loader:
            loss = trainer.step(data, label)
        trainer.sync()           # write weights back into the Block

    ``dtype="bfloat16"`` runs forward and backward in bf16 over f32
    masters and f32 optimizer state; the BatchNorm statistics stay f32.
    ``donate`` is accepted for parity: the trainer always updates its own
    copies in place."""

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, batch_axis="dp", param_specs=None,
                 donate=True, dtype=None):
        from .. import optimizer as opt_mod
        if param_specs:
            raise NotImplementedError(
                "param_specs (sharded parameters) are not ported: the port "
                "trains on one device")
        self._check_knobs(0)
        self.fn = functionalize(block)
        self._check_dense()
        self.block = block
        self.loss_fn = loss_fn
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.compute_dtype = torch.bfloat16 if str(dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else None
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.batch_axis = batch_axis if batch_axis in self.mesh.axis_names \
            else self.mesh.axis_names[0]
        self.device = self.mesh.device
        self.params = None
        self.opt_state = None
        self._step_num = 0
        self._program = None
        self._program_key = None

    def _check_dense(self):
        sparse = [n for n, p in self.fn.params.items()
                  if p.grad_stype != "default"]
        if sparse:
            raise NotImplementedError(
                "sparse-gradient parameters are not ported: %s" % sparse[:4])

    # ---------------------------------------------------------- materialize
    def _materialize(self, data):
        """Copy the Block's parameters onto the mesh's device as the
        trainer's own tensors (masters that require grad, aux state) and
        create the optimizer state.  Deferred shapes are resolved by one
        forward on the first batch."""
        from ..gluon.parameter import DeferredInitializationError
        try:
            vals = self.fn.init_values()
        except DeferredInitializationError:
            self.block(_wrap(data))
            self.fn = functionalize(self.block)
            self._check_dense()
            vals = self.fn.init_values()
        self.params = {n: v.detach().to(self.device, copy=True)
                       for n, v in vals.items()}
        for n in self.fn.trainable:
            self.params[n].requires_grad_(True)
        self.opt_state = {
            n: self.optimizer.create_state(i, self.params[n].detach())
            for i, n in enumerate(self.fn.trainable)}

    # ------------------------------------------------------------ the step
    def _loss_and_grads(self, train, aux, data, label):
        """The step's forward and backward at the given masters:
        ``(loss, new_aux, grads)``, grads in ``fn.trainable`` order, f32
        for f32 masters, contiguous (under ``conv.internal_layout=NHWC``
        a conv weight's gradient comes back channels_last), preprocessed
        (``rescale_grad``, clipping)."""
        fn, cdt = self.fn, self.compute_dtype
        with torch.enable_grad():
            param_map = dict(aux)  # aux (BN stats) stay f32
            if cdt is not None:
                param_map.update({n: v.to(cdt) if v.dtype == torch.float32
                                  else v for n, v in train.items()})
                if data.dtype == torch.float32:  # int inputs keep theirs
                    data = data.to(cdt)
            else:
                param_map.update(train)
            (out,), new_aux = fn.apply(param_map, (data,), training=True)
            if cdt is not None:
                out = out.float()
            loss = _as_scalar_loss(self.loss_fn, out, label)
            masters = [train[n] for n in fn.trainable]
            grads = torch.autograd.grad(loss, masters, allow_unused=True)
        with torch.no_grad():
            grads = [_preprocess(self.optimizer, torch.zeros_like(w)
                                 if g is None else g.contiguous())
                     for w, g in zip(masters, grads)]
        return loss.detach(), new_aux, grads

    def _build(self):
        """The step as a closure over this trainer's configuration, the
        analog of the reference's traced program: built once, rebuilt when
        the kernel tier or any knob changes (``config.epoch``)."""
        optimizer = self.optimizer
        trainable = list(self.fn.trainable)
        fused_opt = _kernels.fused_step_enabled(optimizer)
        if fused_opt:
            # counted once per built step, as the reference counts once per
            # traced program
            _kernels.note_fused_step()

        @torch.no_grad()
        def step(train, aux, opt_state, data, label, t, lrs, wds):
            loss, new_aux, grads = self._loss_and_grads(train, aux, data,
                                                        label)
            masters = [train[n] for n in trainable]
            states = [opt_state[n] for n in trainable]
            if fused_opt and all(w.dtype == torch.float32 for w in masters):
                optimizer.step_fused_multi(masters, grads, states, lrs, wds,
                                           t)
            else:
                for w, g, s, lr, wd in zip(masters, grads, states, lrs,
                                           wds):
                    nw, ns = optimizer.step(w, g, s, lr, wd, t)
                    w.copy_(nw.to(w.dtype))
                    _state_copy(s, ns)
            for n, v in new_aux.items():
                aux[n].copy_(v)
            return loss

        return step

    def _hyper(self, lr_scale=1.0):
        """Per-tensor lr and wd for the current ``num_update`` as f32
        values, lr * lr_scale rounded once in f32, as the reference's
        traced ``lrs[i] * lr_scale``."""
        n = len(self.fn.trainable)
        scale = _np.float32(lr_scale)
        lrs = [float(_np.float32(self.optimizer._get_lr(i)) * scale)
               for i in range(n)]
        wds = [_f32(self.optimizer._get_wd(i)) for i in range(n)]
        return lrs, wds

    def _check_knobs(self, pad):
        if pad:
            raise NotImplementedError("pad-masked steps (pad=%d) are not "
                                      "ported" % pad)
        for knob, what in _UNPORTED_KNOBS.items():
            if _config.get(knob):
                raise NotImplementedError(
                    "%s is not ported (%s=%r)" % (what, knob,
                                                  _config.get(knob)))
        if _config.get("conv.weights_layout") == "HWIO":
            raise NotImplementedError(
                "conv.weights_layout=HWIO is not ported; use 'ref' (OIHW)")

    def step(self, data, label, lr_scale=1.0, pad=0):
        """Run one train step; returns the loss (a 0-d f32 tensor on the
        device, not synchronised)."""
        self._check_knobs(int(pad or 0))
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(label, NDArray):
            label = label._data
        data = torch.as_tensor(data, device=self.device)
        label = torch.as_tensor(label, device=self.device)
        if self.params is None:
            self._materialize(data)
        key = (_kernels.enabled(), _config.epoch())
        if self._program is None or key != self._program_key:
            self._program, self._program_key = self._build(), key
        self._step_num += 1
        self.optimizer.num_update = self._step_num
        lrs, wds = self._hyper(lr_scale)
        train = {k: self.params[k] for k in self.fn.trainable}
        aux = {k: self.params[k] for k in self.fn.aux}
        return self._program(train, aux, self.opt_state, data, label,
                             self._step_num, lrs, wds)

    def sync(self):
        """Write the trainer's weights and aux state back into the
        Block's Parameters."""
        self.fn.write_back({n: v.detach() for n, v in self.params.items()})

    # ------------------------------------------------- not ported (refuse)
    def attach_checkpoint_manager(self, manager, auto_resume=True):
        raise NotImplementedError("the checkpoint manager is not ported")

    def save_checkpoint(self, path):
        raise NotImplementedError("trainer checkpoints are not ported")

    def load_checkpoint(self, path):
        raise NotImplementedError("trainer checkpoints are not ported")

    save_checkpoint_sharded = save_checkpoint
    load_checkpoint_sharded = load_checkpoint


def _state_copy(state, new):
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new)
        return
    for s, n in zip(state, new):
        _state_copy(s, n)


def _preprocess(optimizer, grad):
    if optimizer.rescale_grad == 1.0 and optimizer.clip_gradient is None:
        return grad  # ``grad * 1.0`` is exact: skip the pass
    g = grad * optimizer.rescale_grad
    if optimizer.clip_gradient is not None:
        g = torch.clamp(g, -optimizer.clip_gradient, optimizer.clip_gradient)
    return g


def _raw_loss(loss_fn, out, label):
    """The loss function on NDArrays (Gluon losses), or on tensors when it
    is a plain callable; as f32."""
    try:
        loss = loss_fn(_wrap(out), _wrap(label))
    except (TypeError, AttributeError):
        loss = loss_fn(out, label)
    loss = loss._data if isinstance(loss, NDArray) else loss
    return loss.float()


def _as_scalar_loss(loss_fn, out, label):
    return torch.mean(_raw_loss(loss_fn, out, label))
