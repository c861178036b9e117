"""Optimizer library (counterpart of ``mxnet_tpu.optimizer.optimizer``).

The ``Optimizer`` base keeps the reference's stateful API: a string
registry, per-index update counts, lr/wd and their multipliers,
``rescale_grad`` and gradient clipping, optimizer state per parameter
index, and the f32 master copy of a low-precision weight
(``multi_precision``).  Each optimizer's math is ``step(weight, grad,
state, lr, wd, t) -> (new_weight, new_state)`` in PyTorch ops; an
optimizer with a fused kernel also has ``step_fused``, which updates the
f32 master and writes the low-precision weight in one pass
(``cuda_kernels.fused_adam_step``, ``fused_sgd_step``), and
``step_fused_multi``, which updates a whole list of tensors in one launch
(``cuda_kernels.fused_adam_step_multi``, ``fused_sgd_step_multi``; the
route of ``SPMDTrainer``, of the symbolic ``Executor``'s fused step and of
``update_multi_precision`` over lists).

``update`` and ``update_multi_precision`` take torch tensors in place of
NDArrays and update them IN PLACE (the weight, the master copy and the
state tensors), the analog of the reference writing the new values into
its NDArrays.  ``Updater`` (``get_updater``) is the kvstore-side closure
``gluon.Trainer`` and ``KVStore.set_optimizer`` call with NDArrays: it
keeps one state per parameter index and its ``get_states`` /
``set_states`` round-trip them as bytes.

Ported so far: ``SGD`` and ``Adam``; ``create`` raises for the other
optimizers until their slice.
"""
from __future__ import annotations

import io
import pickle

import torch

from .. import kernels as _kernels
from ..ops import cuda_kernels as _ck

__all__ = ["Optimizer", "create", "register", "SGD", "Adam", "Updater",
           "get_updater"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)
# launch tables an optimizer keeps, one per first master (Optimizer._table_of)
_MAX_TABLES = 4096


def _f32(x):
    return torch.tensor(float(x), dtype=torch.float32)


def _bias_corrected_lr(lr, beta1, beta2, t):
    """Adam's ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)`` in f32, in the
    reference's order: the two coefficients in Python floats, then the
    f32 square root, product and quotient.  Returns a 0-dim f32 tensor."""
    coef1 = 1.0 - beta1 ** t
    coef2 = 1.0 - beta2 ** t
    return _ck.div_rn(_f32(lr) * _ck.sqrt_rn(_f32(coef2)), _f32(coef1))


def _state_write(state, new):
    """Copy new values into the state tree's tensors, in place."""
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new)
        return
    for s, n in zip(state, new):
        _state_write(s, n)


class Optimizer:
    """Base optimizer (reference: ``optimizer.py:51``).

    State is per parameter index, created by ``create_state``; ``update``
    applies one step.  Subclasses implement ``step``."""

    opt_registry = {}

    # ``step`` reads nothing but its arguments; a subclass that keeps
    # Python-side per-step state outside ``state`` sets this False, which
    # also keeps it off the fused kernel (kernels.fused_step_enabled).
    jit_safe = True

    # subclasses with a fused update kernel set this and implement
    # ``step_fused``; it runs when the kernel tier is on
    fused_step = False

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name should be a dict of param "
                            "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # ------------------------------------------------------------- lr & wd
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # only names ending in "_weight" are decayed by default
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _mult(self, index, attr, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._mult(index, "lr_mult",
                                               self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # ------------------------------------------------------------ state API
    def create_state(self, index, weight):
        """Optimizer state for one parameter (None, a tensor or a tuple)."""
        return None

    def create_state_multi_precision(self, index, weight):
        """``(f32 master copy, state of the master)`` for a low-precision
        weight under ``multi_precision``; else ``create_state``."""
        if self.multi_precision and weight.dtype in _LOW_PRECISION:
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # ------------------------------------------------------------ update API
    def step(self, weight, grad, state, lr, wd, t):
        """Pure update: tensors in, ``(new_weight, new_state)`` out."""
        raise NotImplementedError

    def step_fused(self, weight, grad, state, lr, wd, t, out_dtype=None,
                   out=None):
        """One kernel: update + low-precision cast, returning
        ``(weight_cast[out_dtype], new_master_f32, new_state)``;
        ``out=(cast, master, state)`` names the tensors to write (they may
        be the inputs: the kernels update in place)."""
        raise NotImplementedError(
            "%s has no fused step kernel" % type(self).__name__)

    def step_fused_multi(self, weights, grads, states, lrs, wds, t,
                         outs=None):
        """One kernel launch: the update of a list of f32 masters and
        their state, in place, with each master's cast written to its
        ``outs`` entry (``None``: no cast).  ``t`` is the step count, one
        for all or one per tensor.  The launch table is the one
        :meth:`_table_of` keeps for the list."""
        raise NotImplementedError(
            "%s has no fused step kernel" % type(self).__name__)

    def _grad_is_identity(self):
        return self.rescale_grad == 1.0 and (self.clip_gradient is None
                                             or self.clip_gradient <= 0)

    def _fused_grad(self, grad):
        """The grad as the fused kernel takes it: as it is (bf16 or f16
        too) when ``rescale_grad`` is 1 and there is no clipping (the
        reference's f32 widening and ``* 1.0`` are exact), else
        preprocessed in f32."""
        if self._grad_is_identity():
            return grad.contiguous()
        return self._preprocess_grad(grad.float())

    def _uses_master(self, weight, state):
        """Whether ``weight`` updates through the f32 master copy in
        ``state`` (``create_state_multi_precision``)."""
        return (self.multi_precision and weight.dtype in _LOW_PRECISION
                and isinstance(state, tuple) and len(state) == 2
                and isinstance(state[0], torch.Tensor))

    def _master_entry(self, weight, state):
        """``(master, state of the master, weight to cast into or None)``
        for a weight that the fused kernel updates through an f32 master
        under ``multi_precision``: a bf16 or f16 weight's master copy, or
        an f32 weight, which is its own master (no cast); else None."""
        if self._uses_master(weight, state):
            return state[0], state[1], weight
        if self.multi_precision and weight.dtype == torch.float32:
            return weight, state, None
        return None

    def _preprocess_grad(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is None or self.clip_gradient <= 0:
            return g
        return torch.clamp(g, -self.clip_gradient, self.clip_gradient)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """One optimizer step for parameter ``index``: ``weight`` and the
        state tensors are updated in place."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self.update(i, w, g, s)
            return
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = self._preprocess_grad(grad)
        new_w, new_state = self.step(weight, g, state, lr, wd, t)
        weight.copy_(new_w)
        _state_write(state, new_state)

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """``update`` through the f32 master copy of a low-precision
        weight (``state = (master, state)`` from
        ``create_state_multi_precision``): the step runs on the master and
        the weight receives its cast.  With the kernel tier on, one fused
        kernel does both (``step_fused``; ``kernels.fused_step`` counts
        each tensor it updates).  The grad goes into the kernel as
        :meth:`_fused_grad` gives it.

        ``index``, ``weight``, ``grad`` and ``state`` may be lists, one
        entry per parameter, as ``update`` takes them (MXNet's aggregated
        update): with the tier on, the entries that update through their
        master go through one ``step_fused_multi`` call, a single kernel
        launch with their casts; the others are updated one by one.  The
        result is bitwise that of one call per index.

        With the tier on and ``multi_precision``, an f32 weight is its own
        master: it goes through the fused kernel with no cast (in a list,
        in the same launch), where the reference runs its plain ``update``
        (the two differ in the last bits: the kernel contracts its
        multiply-adds)."""
        if isinstance(index, (list, tuple)):
            self._update_multi_precision_list(index, weight, grad, state)
            return
        if not self._uses_master(weight, state):
            if (_kernels.fused_step_enabled(self)
                    and self._master_entry(weight, state) is not None):
                self._update_multi_precision_list([index], [weight], [grad],
                                                  [state])
            else:
                self.update(index, weight, grad, state)
            return
        master, real_state = state
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        if _kernels.fused_step_enabled(self):
            self.step_fused(master, self._fused_grad(grad), real_state, lr,
                            wd, t, out_dtype=weight.dtype,
                            out=(weight, master, real_state))
            _kernels.note_fused_step()
            return
        g = self._preprocess_grad(grad.float())
        new_w, new_state = self.step(master, g, real_state, lr, wd, t)
        master.copy_(new_w)
        weight.copy_(new_w.to(weight.dtype))
        _state_write(real_state, new_state)

    def _update_multi_precision_list(self, indices, weights, grads,
                                     states):
        fused = _kernels.fused_step_enabled(self)
        batch = []
        for idx, w, g, s in zip(indices, weights, grads, states):
            entry = self._master_entry(w, s) if fused else None
            if entry is None:
                self.update_multi_precision(idx, w, g, s)
                continue
            master, real_state, out = entry
            self._update_count(idx)
            batch.append((master, self._fused_grad(g), real_state,
                          self._get_lr(idx), self._get_wd(idx),
                          self._index_update_count[idx], out))
        if not batch:
            return
        masters, gs, sts, lrs, wds, ts, lps = (list(c) for c in zip(*batch))
        self.step_fused_multi(masters, gs, sts, lrs, wds, ts, outs=lps)
        for _ in batch:
            _kernels.note_fused_step()

    def _table_of(self, master):
        """The launch table (``cuda_kernels.LaunchTable``) kept for the
        fused updates whose first master is ``master`` (a trainer's list,
        one parameter of ``gluon.Trainer``): a later update of the same
        tensors finds it filled and rewrites only the grad, lr and wd
        columns."""
        tables = self.__dict__.setdefault("_launch_tables", {})
        table = tables.get(master.data_ptr())
        if table is None:
            if len(tables) >= _MAX_TABLES:   # masters were reallocated
                tables.clear()
            table = tables[master.data_ptr()] = _ck.LaunchTable()
        return table

    def __getstate__(self):
        """Pickled without ``param_dict`` (the Parameters), which whoever
        loads the optimizer sets again, as ``gluon.Trainer`` does, and
        without the kernels' launch tables."""
        ret = self.__dict__.copy()
        ret["param_dict"] = {}
        ret.pop("_launch_tables", None)
        return ret


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum (reference: ``optimizer.py:313``)::

        state = momentum * state + lr * (grad + wd * weight)
        weight = weight - state

    (without momentum, ``weight - lr * (grad + wd * weight)``).  ``step``
    rounds each product and sum once, as the reference's eager ``step``
    does; the fused kernel and its plain version contract the two
    multiply-adds, as the reference's compiled step and its Pallas kernel
    do (``cuda_kernels.fused_sgd_step_plain``).  ``lazy_update`` is
    accepted for parity (there is no sparse path)."""

    fused_step = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def step(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if self.momentum == 0.0:
            return weight - lr * g, None
        mom = self.momentum * state + lr * g
        return weight - mom, mom

    def step_fused(self, weight, grad, state, lr, wd, t, out_dtype=None,
                   out=None):
        """``cuda_kernels.fused_sgd_step``; ``out=(lp, master, mom)`` may
        be the inputs themselves (in place)."""
        return _ck.fused_sgd_step(weight, grad, state, lr, wd, self.momentum,
                                  out_dtype=out_dtype or weight.dtype,
                                  out=out, table=self._table_of(weight))

    def step_fused_multi(self, weights, grads, states, lrs, wds, t,
                         outs=None):
        """One launch of ``cuda_kernels.fused_sgd_step_multi`` over the
        whole list; masters and momenta are updated in place."""
        _ck.fused_sgd_step_multi(weights, grads, states, lrs, wds,
                                 self.momentum, outs=outs,
                                 table=self._table_of(weights[0]))


@register
class Adam(Optimizer):
    """Adam (reference: ``optimizer.py:1371``)::

        m = beta1*m + (1-beta1)*grad
        v = beta2*v + (1-beta2)*grad**2
        lr_t = lr * sqrt(1-beta2**t)/(1-beta1**t)
        w = w - lr_t * m / (sqrt(v) + eps)

    with L2 weight decay folded into the grad (``grad + wd*w``)."""

    fused_step = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update
        self._lr_t = (None, None)   # ((lr, t, beta1, beta2), lr_t)

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step(self, weight, grad, state, lr, wd, t):
        m, v = state
        g = grad + wd * weight
        lr_t = _bias_corrected_lr(lr, self.beta1, self.beta2, t).to(
            weight.device)
        m = self.beta1 * m + (1.0 - self.beta1) * g
        v = self.beta2 * v + (1.0 - self.beta2) * g * g
        # correctly rounded sqrt and quotient (PyTorch's CPU f32 sqrt is
        # not), as the reference's
        w = weight - _ck.div_rn(lr_t * m, _ck.sqrt_rn(v) + self.epsilon)
        return w, (m, v)

    def _lr_t_of(self, lr, t):
        """The bias-corrected ``lr_t`` of ``lr`` at step ``t`` in f32 (the
        bias correction depends on the step count, so it stays outside
        the kernel); the last ``(lr, t)``'s value is kept, since a step
        updates every tensor with the same one."""
        key = (float(lr), int(t), self.beta1, self.beta2)
        if self._lr_t[0] != key:
            self._lr_t = (key, float(_bias_corrected_lr(
                lr, self.beta1, self.beta2, t)))
        return self._lr_t[1]

    def step_fused(self, weight, grad, state, lr, wd, t, out_dtype=None,
                   out=None):
        """``cuda_kernels.fused_adam_step`` with ``lr_t`` from
        :meth:`_lr_t_of`.  ``out=(lp, master, (m, v))`` may be the inputs
        themselves: the kernel then updates them in place."""
        m, v = state
        if out is not None:
            lp, nw, (nm, nv) = out
            out = (lp, nw, nm, nv)
        return _ck.fused_adam_step(
            weight, grad, m, v, self._lr_t_of(lr, t), wd, self.beta1,
            self.beta2, self.epsilon, out_dtype=out_dtype or weight.dtype,
            out=out, table=self._table_of(weight))

    def step_fused_multi(self, weights, grads, states, lrs, wds, t,
                         outs=None):
        """One launch of ``cuda_kernels.fused_adam_step_multi`` over the
        whole list: masters, m and v are updated in place and ``outs``
        (per tensor a bf16 or f16 weight, or ``None`` for an f32 cast,
        the master itself) receive the casts.  Each tensor's ``lr_t``
        comes from its own lr and step count (``t``: one for all, or one
        per tensor) as in :meth:`step_fused`."""
        ts = t if isinstance(t, (list, tuple)) else [t] * len(weights)
        _ck.fused_adam_step_multi(
            weights, grads, [s[0] for s in states], [s[1] for s in states],
            [self._lr_t_of(lr, ti) for lr, ti in zip(lrs, ts)], wds,
            self.beta1, self.beta2, self.epsilon, outs=outs,
            table=self._table_of(weights[0]))


def _state_to(state, device):
    """The state tree with its tensors on ``device``."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return tuple(_state_to(x, device) for x in state)


class Updater:
    """The kvstore-side updater closure (reference: ``optimizer.py:835``):
    ``updater(index, grad, weight)`` on NDArrays creates the index's
    state at its first call (``create_state_multi_precision``) and runs
    ``update_multi_precision`` in place on the weight's tensor; lists of
    indices, grads and weights go on as one list call."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        many = isinstance(index, (list, tuple))
        if not many:
            index, grad, weight = [index], [grad], [weight]
        for idx, w in zip(index, weight):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(
                        idx, w._data.detach())
                self.states_synced[idx] = True
            elif not self.states_synced[idx]:
                self.states[idx] = self.sync_state_context(
                    self.states[idx], w._data.device)
                self.states_synced[idx] = True
        if many:
            self.optimizer.update_multi_precision(
                list(index), [w._data for w in weight],
                [g._data for g in grad], [self.states[i] for i in index])
            return
        self.optimizer.update_multi_precision(index[0], weight[0]._data,
                                              grad[0]._data,
                                              self.states[index[0]])

    def sync_state_context(self, state, context):
        """The state on the weight's device (``context``: a
        ``torch.device`` or a Context)."""
        from ..context import resolve_device
        return _state_to(state, resolve_device(context))

    def set_states(self, states):
        """Load states written by :meth:`get_states`; each moves to its
        weight's device at its next update."""
        states = torch.load(io.BytesIO(states), weights_only=False)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = states
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        """The states (and, with ``dump_optimizer``, the optimizer) as
        bytes, tensors on the CPU."""
        states = {k: _state_to(v, "cpu") for k, v in self.states.items()}
        buf = io.BytesIO()
        torch.save((states, self.optimizer) if dump_optimizer else states,
                   buf, pickle_protocol=pickle.HIGHEST_PROTOCOL)
        return buf.getvalue()


def get_updater(optimizer):
    return Updater(optimizer)
