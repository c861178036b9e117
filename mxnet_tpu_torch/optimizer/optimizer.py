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

``create_state``, ``create_state_multi_precision``, ``update`` and
``update_multi_precision`` take NDArrays, as the reference's do: given an
NDArray weight the state is made of NDArrays, and an update writes each
NDArray's new value by rebinding its tensor (the reference's functional
write: an update on NDArrays runs the tensor route on copies).  They
also take torch tensors, which they update IN PLACE (the weight, the
master copy and the state tensors): the route of the port's own callers.
``Updater`` (``get_updater``) is the kvstore-side closure
``gluon.Trainer`` and ``KVStore.set_optimizer`` call with NDArrays: it
keeps one state per parameter index as tensors and its ``get_states`` /
``set_states`` round-trip them as bytes.

Every optimizer of the reference is here under its registered name:
``SGD`` and ``ccSGD`` (fused kernel K1), ``Adam`` (K3), and ``Signum``,
``SignSGD``, ``FTML``, ``LARS``, ``LBSGD``, ``DCASGD``, ``NAG``, ``SGLD``,
``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``, ``Nadam``,
``Test`` and ``GroupAdaGrad``, whose steps are PyTorch ops in the
reference's op order (a quotient or square root is correctly rounded,
:func:`_div` / ``cuda_kernels.sqrt_rn``, as the reference's f32 ones are).

``Updater.set_states`` also reads a states file written by the
reference's ``get_states`` (a pickle of numpy arrays and the reference's
Optimizer): :class:`_ReferenceUnpickler` maps the reference's optimizer
and LR-scheduler classes onto this package's and refuses every other
name of the reference package.
"""
from __future__ import annotations

import functools
import io
import math
import pickle

import numpy as _np
import torch

from .. import kernels as _kernels
from ..ops import cuda_kernels as _ck

__all__ = ["Optimizer", "create", "register", "Updater", "get_updater",
           "SGD", "Signum", "SignSGD", "FTML", "LARS", "LBSGD", "DCASGD", "NAG",
           "SGLD", "ccSGD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "GroupAdaGrad"]

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


def _div(a, b):
    """``a / b`` in f32 rounded once (``cuda_kernels.div_rn``); a Python
    number takes its f32 value first, as the reference's weakly typed
    scalars do."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(float(b), dtype=torch.float32, device=a.device)
    return _ck.div_rn(a, b)


def _is_array(x):
    """Whether ``x`` (or, for a list or tuple, any entry) is an
    NDArray."""
    from ..ndarray.ndarray import NDArray
    if isinstance(x, (list, tuple)):
        return any(_is_array(v) for v in x if v is not None)
    return isinstance(x, NDArray)


def _tensors(x):
    """An NDArray tree (a weight, a grad, a state, or lists of them) as
    the tree of its tensors."""
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors(v) for v in x)
    return getattr(x, "_data", x)


def _copies(x):
    """``_tensors(x)`` with every tensor a copy, for an update to write."""
    if isinstance(x, (list, tuple)):
        return type(x)(_copies(v) for v in x)
    return None if x is None else x._data.detach().clone()


def _rebind(arrays, tensors):
    """Each NDArray of the tree ``arrays`` takes its tensor in
    ``tensors`` as its value."""
    if isinstance(arrays, (list, tuple)):
        for a, t in zip(arrays, tensors):
            _rebind(a, t)
    elif arrays is not None:
        arrays._set_data(tensors)


def _arrays(state):
    """A state tree's tensors as NDArrays (each the tensor's handle)."""
    from ..ndarray.ndarray import _wrap
    if isinstance(state, (list, tuple)):
        return type(state)(_arrays(v) for v in state)
    return None if state is None else _wrap(state)


def _state_write(state, new):
    """Copy new values into the state tree's tensors, in place."""
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new)
        return
    for s, n in zip(state, new):
        _state_write(s, n)


def _row_index(rows, n):
    """``(valid, safe)`` for row ids ``rows`` of an ``n``-row table: which
    are inside it, and the ids with the outside ones replaced by 0 (an
    index op never sees an out-of-range row)."""
    rows = rows.to(torch.int64)
    valid = (rows >= 0) & (rows < n)
    return valid, torch.where(valid, rows, torch.zeros_like(rows))


def _write_rows(table, valid, safe, vals):
    """``table[safe[i]] = vals[i]`` for the valid entries, in place; the
    others are dropped (the reference's out-of-range scatter).  The
    dropped entries are pointed at the first valid entry's row with its
    value (or at row 0 with its own value when none is valid), so every
    write to a row carries the same bits and no duplicate index has a
    winner to pick.  Index tensors only: no value comes to the host."""
    shape = (-1,) + (1,) * (vals.dim() - 1)
    k = torch.argmax(valid.to(torch.uint8)).reshape(1)
    any_valid = valid.index_select(0, k)
    zero = torch.zeros_like(k)
    f_row = torch.where(any_valid, safe.index_select(0, k), zero)
    f_val = torch.where(any_valid.view(shape), vals.index_select(0, k),
                        table.index_select(0, zero))
    idx = torch.where(valid, safe, f_row)
    src = torch.where(valid.view(shape), vals, f_val)
    table.index_put_((idx,), src)


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
        """Optimizer state for one parameter (None, a tensor or a tuple;
        of NDArrays for an NDArray weight)."""
        return None

    def create_state_multi_precision(self, index, weight):
        """``(f32 master copy, state of the master)`` for a low-precision
        weight under ``multi_precision``; else ``create_state``.  An
        NDArray weight gets NDArrays."""
        if _is_array(weight):
            return _arrays(self.create_state_multi_precision(index,
                                                             weight._data))
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

    def _update_arrays(self, update, index, weight, grad, state):
        """``update`` (:meth:`update` or :meth:`update_multi_precision`)
        on NDArrays: the tensor route on copies of the weights and states,
        then each NDArray rebound to its new value."""
        weights, states = _copies(weight), _copies(state)
        update(index, weights, _tensors(grad), states)
        _rebind(weight, weights)
        _rebind(state, states)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """One optimizer step for parameter ``index``: ``weight`` and the
        state tensors are updated in place (NDArrays take their new
        values).  ``index``, ``weight``, ``grad`` and ``state`` may be
        lists, one entry per parameter."""
        if _is_array(weight):
            self._update_arrays(self.update, index, weight, grad, state)
            return
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

    def lazy_rows(self):
        """Whether a row-sparse gradient takes the lazy row update
        (:meth:`update_rows`): the reference's rule, ``lazy_update`` set
        and a ``step_rows`` defined (``optimizer.py:214-230``)."""
        return bool(getattr(self, "lazy_update", False)) and \
            hasattr(self, "step_rows")

    @torch.no_grad()
    def update_rows(self, index, weight, rows, grad, state):
        """The lazy row-sparse update of parameter ``index`` (the
        reference's ``update`` of a ``RowSparseNDArray`` gradient): the
        step is counted and ``step_rows`` runs on ``rows`` only (unique
        ids; those outside the table are dropped), with ``grad``'s rows
        preprocessed.  Rows outside ``rows`` see no weight decay and no
        state decay.  ``weight``, ``grad`` and ``state`` are tensors, the
        weight and state updated in place."""
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        if rows.numel() == 0:
            return
        _, safe = _row_index(rows, weight.shape[0])
        g = self._preprocess_grad(grad.index_select(0, safe))
        self.step_rows(weight, rows, g, state, lr, wd, t)

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
        multiply-adds).

        NDArrays (and lists of them) take their new values as in
        :meth:`update`."""
        if _is_array(weight):
            self._update_arrays(self.update_multi_precision, index, weight,
                                grad, state)
            return
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

    def __setstate__(self, state):
        """A pickled optimizer, this package's or the reference's (whose
        ``param_dict`` holds the reference's Parameters: dropped, since
        whoever loads the optimizer sets it again)."""
        self.__dict__.update(state)
        self.param_dict = {}


def _array_state(create_state):
    """``create_state`` that also takes an NDArray weight, whose state is
    then made of NDArrays."""
    @functools.wraps(create_state)
    def wrapper(self, index, weight):
        if _is_array(weight):
            return _arrays(create_state(self, index, weight._data))
        return create_state(self, index, weight)
    return wrapper


def _f32_scalar(x, device):
    """``x`` as a 0-dim f32 tensor on ``device``, made by a fill (no copy
    from the host, so the host does not wait for the card)."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


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
    do (``cuda_kernels.fused_sgd_step_plain``).  ``lazy_update`` marks
    the lazy row-sparse step :meth:`step_rows`, which ``SPMDTrainer``'s
    embedding route takes."""

    fused_step = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if _is_array(weight):
            return _arrays(self.create_state(index, weight._data))
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

    @torch.no_grad()
    def step_rows(self, weight, rows, grad_rows, state, lr, wd, t):
        """Lazy row-sparse step (reference ``optimizer.py:347``), in
        place: only ``rows`` of ``weight`` and of the momentum are read and
        written, and a row outside the table is dropped.  Rounds as the
        reference's compiled ``step_rows``: ``g = fma(wd, w, grad)``; then
        ``w + (-lr * g)``, or with momentum ``m = fma(momentum, m, lr * g)``
        and ``w + (-m)``.  Returns ``(weight, state)``."""
        valid, r = _row_index(rows, weight.shape[0])
        dev = weight.device
        lr_, wd_ = _f32_scalar(lr, dev), _f32_scalar(wd, dev)
        w = weight.index_select(0, r)
        g = _ck._fma(wd_, w, grad_rows.float())
        if self.momentum == 0.0:
            _write_rows(weight, valid, r, w + (-lr_ * g))
            return weight, state
        m = _ck._fma(_f32_scalar(self.momentum, dev),
                     state.index_select(0, r), lr_ * g)
        _write_rows(weight, valid, r, w + (-m))
        _write_rows(state, valid, r, m)
        return weight, state


@register
class Signum(Optimizer):
    """Sign-of-momentum SGD (reference: ``optimizer.py:359``)::

        mom = momentum * mom - (1 - momentum) * (grad + wd * weight)
        weight = (1 - lr * wd_lh) * weight + lr * sign(mom)

    and without momentum ``(1 - lr * (wd + wd_lh)) * weight - lr *
    sign(grad)``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    @_array_state
    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def step(self, weight, grad, state, lr, wd, t):
        if state is not None:
            mom = self.momentum * state - (1 - self.momentum) * (
                grad + wd * weight)
            return ((1 - lr * self.wd_lh) * weight + lr * torch.sign(mom),
                    mom)
        return ((1 - lr * (wd + self.wd_lh)) * weight
                - lr * torch.sign(grad), None)


@register
class SignSGD(Signum):
    """``Signum`` without momentum (reference: ``optimizer.py:382``)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (reference: ``optimizer.py:389``)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    @_array_state
    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight) for _ in range(3))

    def step(self, weight, grad, state, lr, wd, t):
        prev_d, prev_v, prev_z = state
        g = grad + wd * weight
        v = self.beta2 * prev_v + (1 - self.beta2) * g * g
        d = (1 - self.beta1 ** t) / lr * (
            _ck.sqrt_rn(_div(v, 1 - self.beta2 ** t)) + self.epsilon)
        sigma = d - self.beta1 * prev_d
        z = self.beta1 * prev_z + (1 - self.beta1) * g - sigma * weight
        return _div(-z, d), (d, v, z)


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling (reference: ``optimizer.py:414``):
    SGD whose lr is scaled by ``eta * |w| / (|g| + wd * |w| + eps)`` when
    both norms are positive.  The norms stay on the weight's device."""

    def __init__(self, momentum=0.0, lazy_update=True, eta=0.001, eps=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.eps = eps

    @_array_state
    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def step(self, weight, grad, state, lr, wd, t):
        w_norm = torch.linalg.vector_norm(weight.reshape(-1))
        g_norm = torch.linalg.vector_norm(grad.reshape(-1))
        ratio = torch.where((w_norm > 0) & (g_norm > 0),
                            _div(self.eta * w_norm,
                                 g_norm + wd * w_norm + self.eps),
                            _f32_scalar(1.0, weight.device))
        lr_adj = lr * ratio
        g = grad + wd * weight
        if self.momentum == 0.0:
            return weight - lr_adj * g, None
        mom = self.momentum * state + lr_adj * g
        return weight - mom, mom


@register
class LBSGD(Optimizer):
    """Large-batch SGD with lr warmup (reference: ``optimizer.py:444``):
    the lr is multiplied by the warmup strategy's factor (``linear``,
    ``power2`` or ``sqrt``) at the optimizer's ``num_update``."""

    # step() reads num_update for the warmup factor
    jit_safe = False

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    @_array_state
    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def step(self, weight, grad, state, lr, wd, t):
        self.lbmult = self._get_lbmult(self.num_update)
        lr = lr * self.lbmult
        g = grad + wd * weight
        if self.momentum == 0.0:
            return weight - lr * g, None
        mom = self.momentum * state + lr * g
        return weight - mom, mom


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference:
    ``optimizer.py:502``); the state is ``(momentum or None, previous
    weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    @_array_state
    def create_state(self, index, weight):
        previous = weight.detach().clone()
        if self.momentum == 0.0:
            return (None, previous)
        return (torch.zeros_like(weight), previous)

    def step(self, weight, grad, state, lr, wd, t):
        mom, previous_weight = state
        g = grad + wd * weight
        comp = g + self.lamda * g * g * (weight - previous_weight)
        if mom is None:
            new_mom = None
            delta = -lr * comp
        else:
            new_mom = self.momentum * mom - lr * comp
            delta = new_mom
        new_w = weight + delta
        return new_w, (new_mom, new_w)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: ``optimizer.py:531``)::

        state = momentum * state + grad + wd * weight
        weight = weight - lr * (grad + wd * weight + momentum * state)
    """

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    @_array_state
    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def step(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if self.momentum == 0.0:
            return weight - lr * g, None
        mom = self.momentum * state + g
        return weight - lr * (g + self.momentum * mom), mom


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (reference:
    ``optimizer.py:556``): ``weight - lr / 2 * (grad + wd * weight) +
    N(0, lr)``.  The noise is drawn on the weight's device with
    ``random.generator`` (a generator seeded from ``mx.random``'s
    stream); the two packages' streams differ, so only the deterministic
    part and the noise's moments can be held against the reference."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def _noise(self, weight):
        from .. import random as _random
        return torch.randn(weight.shape, dtype=weight.dtype,
                           device=weight.device,
                           generator=_random.generator(weight.device))

    def step(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        root = _ck.sqrt_rn(torch.tensor(lr, dtype=weight.dtype,
                                        device=weight.device))
        noise = self._noise(weight) * root.to(weight.dtype)
        return weight - lr / 2 * g + noise, None


@register
class ccSGD(SGD):
    """The deprecated alias of ``SGD`` (reference: ``optimizer.py:573``);
    its fused step is SGD's, K1."""


@register
class Adam(Optimizer):
    """Adam (reference: ``optimizer.py:1371``)::

        m = beta1*m + (1-beta1)*grad
        v = beta2*v + (1-beta2)*grad**2
        lr_t = lr * sqrt(1-beta2**t)/(1-beta1**t)
        w = w - lr_t * m / (sqrt(v) + eps)

    with L2 weight decay folded into the grad (``grad + wd*w``)."""

    fused_step = True
    # the last (lr, t)'s lr_t; an Adam pickled by the reference has none
    _lr_t = (None, None)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update
        self._lr_t = (None, None)   # ((lr, t, beta1, beta2), lr_t)

    def create_state(self, index, weight):
        if _is_array(weight):
            return _arrays(self.create_state(index, weight._data))
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

    @torch.no_grad()
    def step_rows(self, weight, rows, grad_rows, state, lr, wd, t):
        """Lazy row-sparse Adam (reference ``optimizer.py:624``), in place:
        the moments and the weight change only at ``rows`` (a row outside
        the table is dropped).  Rounds as the reference's compiled
        ``step_rows`` and K3: ``g = fma(wd, w, grad)``, ``m =
        fma(b1, m, (1-b1) g)``, ``v = fma(b2, v, ((1-b2) g) g)``, ``w +
        (-lr_t m) / (sqrt(v) + eps)`` with the square root and quotient
        correctly rounded; ``lr_t`` as :meth:`step` takes it (Python
        floats for the bias correction).  Returns ``(weight, state)``."""
        m, v = state
        valid, r = _row_index(rows, weight.shape[0])
        dev = weight.device
        f32 = functools.partial(_f32_scalar, device=dev)
        w = weight.index_select(0, r)
        g = _ck._fma(f32(wd), w, grad_rows.float())
        lr_t = f32(_bias_corrected_lr(lr, self.beta1, self.beta2, t))
        nm = _ck._fma(f32(self.beta1), m.index_select(0, r),
                      f32(1.0 - self.beta1) * g)
        nv = _ck._fma(f32(self.beta2), v.index_select(0, r),
                      (f32(1.0 - self.beta2) * g) * g)
        upd = _ck.div_rn(-lr_t * nm, _ck.sqrt_rn(nv) + f32(self.epsilon))
        _write_rows(weight, valid, r, w + upd)
        _write_rows(m, valid, r, nm)
        _write_rows(v, valid, r, nv)
        return weight, state


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: ``optimizer.py:640``)::

        hist = hist + g * g
        weight = weight - lr * g / (sqrt(hist) + eps)

    with ``g = grad + wd * weight``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    @_array_state
    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def step(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        hist = state + g * g
        return (weight - _div(lr * g, _ck.sqrt_rn(hist)
                              + self.float_stable_eps), hist)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or ``centered`` (Graves' form; reference:
    ``optimizer.py:658``), with ``clip_weights``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    @_array_state
    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(torch.zeros_like(weight) for _ in range(n))

    def _clip(self, w):
        if self.clip_weights:
            return torch.clamp(w, -self.clip_weights, self.clip_weights)
        return w

    def step(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if self.centered:
            n, gm, delta = state
            n = (1 - self.gamma1) * g * g + self.gamma1 * n
            gm = (1 - self.gamma1) * g + self.gamma1 * gm
            delta = self.gamma2 * delta - _div(
                lr * g, _ck.sqrt_rn(n - gm * gm + self.epsilon))
            return self._clip(weight + delta), (n, gm, delta)
        (n,) = state
        n = (1 - self.gamma1) * g * g + self.gamma1 * n
        w = weight - _div(lr * g, _ck.sqrt_rn(n + self.epsilon))
        return self._clip(w), (n,)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: ``optimizer.py:696``)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    @_array_state
    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step(self, weight, grad, state, lr, wd, t):
        acc_g, acc_delta = state
        g = grad + wd * weight
        acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = _div(_ck.sqrt_rn(acc_delta + self.epsilon),
                     _ck.sqrt_rn(acc_g + self.epsilon)) * g
        acc_delta = self.rho * acc_delta + (1.0 - self.rho) * delta * delta
        return weight - delta, (acc_g, acc_delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: ``optimizer.py:718``); the state is
    ``(z, n)`` and ``wd`` enters the closed form, not the grad."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    @_array_state
    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step(self, weight, grad, state, lr, wd, t):
        z, n = state
        g = grad
        sigma = _div(_ck.sqrt_rn(n + g * g) - _ck.sqrt_rn(n), lr)
        z = z + g - sigma * weight
        n = n + g * g
        w = (_div(torch.sign(z) * self.lamda1 - z,
                  _div(self.beta + _ck.sqrt_rn(n), lr) + wd)
             * (torch.abs(z) > self.lamda1))
        return w, (z, n)


@register
class Adamax(Optimizer):
    """AdaMax, Adam over the infinity norm (reference:
    ``optimizer.py:742``)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    @_array_state
    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step(self, weight, grad, state, lr, wd, t):
        m, u = state
        g = grad + wd * weight
        lr_t = lr / (1.0 - self.beta1 ** t)
        m = self.beta1 * m + (1.0 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        return weight - _div(lr_t * m, u + 1e-8), (m, u)


@register
class Nadam(Optimizer):
    """Nesterov-accelerated Adam (reference: ``optimizer.py:763``).  The
    momentum schedule's running product ``m_schedule`` is one Python
    float of the optimizer, advanced by every update (of every index),
    as in the reference."""

    # step() advances m_schedule, host state outside ``state``
    jit_safe = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    @_array_state
    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step(self, weight, grad, state, lr, wd, t):
        m, v = state
        g = grad + wd * weight
        momentum_t = self.beta1 * (
            1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        grad_prime = _div(g, 1.0 - self.m_schedule)
        m = self.beta1 * m + (1.0 - self.beta1) * g
        v = self.beta2 * v + (1.0 - self.beta2) * g * g
        m_prime = _div(m, 1.0 - m_schedule_next)
        v_prime = _div(v, 1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
        w = weight - _div(lr * m_bar, _ck.sqrt_rn(v_prime) + self.epsilon)
        return w, (m, v)


@register
class Test(Optimizer):
    """The mock optimizer of the kvstore tests (reference:
    ``optimizer.py:801``): ``weight + grad * rescale_grad`` (the grad
    arrives rescaled already, so the rescale applies twice, as there)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    @_array_state
    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def step(self, weight, grad, state, lr, wd, t):
        return weight + grad * self.rescale_grad, state


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator a row (reference:
    ``optimizer.py:815``); weight decay is not supported."""

    def __init__(self, learning_rate=0.05, eps=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    @_array_state
    def create_state(self, index, weight):
        return torch.zeros((weight.shape[0], 1), dtype=weight.dtype,
                           device=weight.device)

    def step(self, weight, grad, state, lr, wd, t):
        if wd != 0:
            raise ValueError("Weight decay is not supported for "
                             "GroupAdaGrad")
        sq = grad * grad
        if grad.dim() > 1:   # torch.mean over no dims would mean all dims
            sq = torch.mean(sq, dim=tuple(range(1, grad.dim())),
                            keepdim=True)
        hist = state + sq.reshape(state.shape)
        root = _ck.sqrt_rn(hist).reshape((-1,) + (1,) * (grad.dim() - 1))
        return weight - _div(lr * grad, root + self.float_stable_eps), hist


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

    def _ensure_state(self, idx, w):
        if idx not in self.states:
            self.states[idx] = self.optimizer.create_state_multi_precision(
                idx, w._data.detach())
            self.states_synced[idx] = True
        elif not self.states_synced[idx]:
            self.states[idx] = self.sync_state_context(self.states[idx],
                                                       w._data.device)
            self.states_synced[idx] = True
        return self.states[idx]

    def update_rows(self, index, rows, grad, weight):
        """The lazy row-sparse update of one NDArray ``weight`` over the
        row ids ``rows`` (``Optimizer.update_rows``).  A low-precision
        weight under ``multi_precision`` updates densely through its
        master, as the reference's ``update_multi_precision`` does."""
        state = self._ensure_state(index, weight)
        if self.optimizer._uses_master(weight._data, state):
            self(index, grad, weight)
            return
        self.optimizer.update_rows(index, weight._data, rows, grad._data,
                                   state)

    def __call__(self, index, grad, weight):
        many = isinstance(index, (list, tuple))
        if not many:
            index, grad, weight = [index], [grad], [weight]
        for idx, w in zip(index, weight):
            self._ensure_state(idx, w)
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
        """Load states written by :meth:`get_states`, or by the
        reference's (a pickle of numpy arrays, read through
        :class:`_ReferenceUnpickler`); each moves to its weight's device
        at its next update."""
        if states[:2] == b"PK":   # torch.save's zip container
            states = torch.load(io.BytesIO(states), weights_only=False)
        else:
            states = _ReferenceUnpickler(io.BytesIO(states)).load()
            states = (_from_numpy(states[0]), states[1]) \
                if isinstance(states, tuple) else _from_numpy(states)
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


def _from_numpy(tree):
    """A reference state tree (numpy arrays in dicts and tuples) as
    tensors."""
    if isinstance(tree, dict):
        return {k: _from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_from_numpy(v) for v in tree)
    if isinstance(tree, _np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


class _Dropped:
    """What a reference object that only rides along in a pickled
    optimizer becomes (the reference Trainer's Parameters in
    ``param_dict``, their arrays and contexts): nothing of it is kept,
    since the loader sets ``param_dict`` again."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _dropped(*args, **kwargs):
    return _Dropped()


# the reference package's name of each class its pickled optimizer may
# hold -> this package's counterpart
_REF_ROOT = "mxnet_tpu"
_REF_CLASSES = {(_REF_ROOT + ".optimizer.optimizer", name): name
                for name in __all__ if name[0].isupper()
                and name != "Updater"}
_REF_SCHEDULERS = ("LRScheduler", "FactorScheduler", "MultiFactorScheduler",
                   "PolyScheduler", "CosineScheduler")
_REF_RIDERS = {(_REF_ROOT + ".gluon.parameter", "Parameter"),
               (_REF_ROOT + ".gluon.parameter", "Constant"),
               (_REF_ROOT + ".ndarray.ndarray", "NDArray"),
               (_REF_ROOT + ".context", "Context"),
               ("jax._src.array", "_reconstruct_array")}
_NUMPY_NAMES = {("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy", "ndarray"), ("numpy", "dtype")}


class _ReferenceUnpickler(pickle.Unpickler):
    """Reads a pickle the reference package wrote (its optimizer states,
    its trainer checkpoints) without importing it: numpy's array names
    load as themselves; the reference's optimizer and LR-scheduler
    classes load as this package's; the reference Trainer's Parameters
    (and their arrays and contexts) that ride along in an optimizer's
    ``param_dict`` load as :class:`_Dropped`; every other name raises
    ``pickle.UnpicklingError``."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        if (module, name) in _REF_CLASSES:
            return globals()[_REF_CLASSES[(module, name)]]
        if module == _REF_ROOT + ".lr_scheduler" and name in _REF_SCHEDULERS:
            from .. import lr_scheduler
            return getattr(lr_scheduler, name)
        if (module, name) in _REF_RIDERS:
            return _dropped if name.startswith("_") else _Dropped
        raise pickle.UnpicklingError(
            "refusing %s.%s in a pickled optimizer state" % (module, name))
