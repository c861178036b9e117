"""BERT — bidirectional encoder with the masked-LM and next-sentence
pretraining heads (counterpart of ``mxnet_tpu.models.bert``).

The encoder is TransformerLM's layer stack (``TransformerLM.run_stack``)
with ``causal=False``: with the kernel tier on, every layer's attention
is the flash kernel's non-causal path, forward and backward.  BERT adds
token-type embeddings before the stack, a tanh pooler over the first
position, the masked-LM head (gathered positions, an f32 transform with
tanh-approximate GELU, the norm, the readout tied to the embedding
matrix) and the next-sentence head.  The masked positions are a fixed
``M`` per example with weights (0 on padding), so every shape is static.

Parameters carry the reference's flat names (``embed``, ``pos_embed``,
``final_norm``, ``layers.*``, ``type_embed``, ``pooler_w``, ...,
``mlm_bias_v``), so ``convert.params_from_reference`` loads the
reference's tree through ``BERT.load_state_dict`` as it is.  The encoder's
parameters are BERT's own: ``self.encoder`` is a TransformerLM that
shares them and is not a submodule.  ``mlm_bias_v`` is f32 whatever the
model dtype, as in the reference.

Over a mesh (``mesh=``) the encoder takes TransformerLM's splits, and the
pooler and the MLM transform are split on their columns over ``tp``
(:meth:`BERT.param_specs`, the reference's): each rank computes its
columns, and the columns are gathered before the next-sentence head
and before the MLM norm, which runs over the whole ``d_model``.  Every
rank passes the global batch and takes its rows over ``dp``; the loss
sums each rank's rows over ``dp`` before it divides, and
:meth:`BERT.allreduce_grads` sums the gradients over ``dp`` and ``sp``.

Over ``sp`` the encoder runs the rank's block of the sequence (ring
attention, positions offset by the block's start).  The pooler reads
position 0 and the masked-LM head positions anywhere, so the encoder's
output is gathered whole over ``sp`` before them, by an all-gather whose
backward takes this rank's block of the cotangent summed over ``sp``;
:meth:`BERT.pretrain_loss` then runs the heads on this rank's share of
its ``dp`` rows (split over ``sp``), so every row's loss counts once and
each rank's cotangent is its share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as _coll
from ..parallel.mesh import PartitionSpec as P
from .transformer import (TransformerLM, TransformerLMConfig, _norm,
                          init_weights)

__all__ = ["BERTConfig", "BERT", "bert_base"]


class BERTConfig(TransformerLMConfig):
    def __init__(self, vocab_size=30522, num_layers=12, d_model=768,
                 num_heads=12, d_ff=3072, max_len=512, type_vocab=2,
                 dtype=torch.bfloat16):
        super().__init__(vocab_size=vocab_size, num_layers=num_layers,
                         d_model=d_model, num_heads=num_heads, d_ff=d_ff,
                         max_len=max_len, dtype=dtype, causal=False)
        self.type_vocab = type_vocab


def bert_base(**overrides):
    return BERTConfig(**overrides)


#: parameters set to one / to zero by :meth:`BERT.init`; the rest are
#: normal(0, 0.02)
_ONES = ("ln1", "ln2", "final_norm", "mlm_norm")
_ZEROS = ("pooler_b", "nsp_b", "mlm_b", "mlm_bias_v")


class BERT(nn.Module):
    """Encoder and pretraining heads over the shared transformer stack.

    ``device`` defaults to ``cuda:0`` (``mesh.device`` with a mesh) and
    raises without a GPU; pass ``device="cpu"`` to run on the CPU.
    ``mesh`` splits the model (module docstring).  Parameters are created
    without gradients (``model.requires_grad_(True)`` switches them
    on)."""

    def __init__(self, config, mesh=None, device=None):
        super().__init__()
        self.cfg = config
        enc = TransformerLM(config, mesh=mesh, device=device)
        self.mesh = mesh
        dev = enc.device
        tp = mesh.shape["tp"] if enc._tp_live else 1
        # the encoder's parameters are BERT's, under the reference's names
        self.embed = enc.embed
        self.pos_embed = enc.pos_embed
        self.final_norm = enc.final_norm
        self.layers = enc.layers
        object.__setattr__(self, "encoder", enc)
        D, dt = config.d_model, config.dtype

        def p(*shape, dtype=dt):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.type_embed = p(config.type_vocab, D)
        self.pooler_w = p(D, D // tp)
        self.pooler_b = p(D // tp)
        self.nsp_w = p(D, 2)
        self.nsp_b = p(2)
        # the MLM transform before the tied-embedding readout
        self.mlm_w = p(D, D // tp)
        self.mlm_b = p(D // tp)
        self.mlm_norm = p(D)
        self.mlm_bias_v = p(config.vocab_size, dtype=torch.float32)

    @property
    def device(self):
        return self.embed.device

    # -------------------------------------------------------------- params
    def init(self, seed=0):
        """Random weights from ``seed``, the reference's distribution:
        normal(0, 0.02) matrices, unit norm scales, zero biases."""
        return init_weights(self, seed, _ONES, _ZEROS)

    def param_specs(self):
        """The PartitionSpec of each parameter (the reference's): the
        encoder's, and the pooler and the MLM transform split on their
        columns over ``tp``."""
        specs = self.encoder.param_specs()
        tp = self.encoder._tp
        specs.update({
            "type_embed": P(None, None),
            "pooler_w": P(None, tp),
            "pooler_b": P(tp),
            "nsp_w": P(None, None),
            "nsp_b": P(None),
            "mlm_w": P(None, tp),
            "mlm_b": P(tp),
            "mlm_norm": P(None),
            "mlm_bias_v": P(None),
        })
        return specs

    flat_specs = TransformerLM.flat_specs
    # sums every gradient over dp and sp
    allreduce_grads = TransformerLM.allreduce_grads

    @property
    def _batch_live(self):
        return self.encoder._batch_live

    # ------------------------------------------------------------- forward
    def _index(self, x):
        return self.encoder._as_index(x)

    def _rows(self, x):
        """This rank's rows (over ``dp``) of a global [B, ...] index
        array, as int64 on the model's device."""
        x = self._index(x)
        if self.mesh is None:
            return x
        return _coll.local_block(x, self.mesh, (self.encoder._dp,))

    def _head_axes(self):
        """The axes a row of the heads splits over: ``dp``, then ``sp``."""
        enc = self.encoder
        return tuple(a for a in (enc._dp, enc._sp_live) if a)

    def _head_rows(self, x):
        """This rank's rows of the heads (over ``dp`` and ``sp``) of a
        global [B, ...] array."""
        if self.mesh is None:
            return x
        return _coll.local_block(x, self.mesh, (self._head_axes(),))

    def _whole_seq(self, h):
        """The encoder's output [B, S / sp, D] gathered whole over ``sp``
        (backward: this rank's block of the cotangent summed over
        ``sp``)."""
        sp = self.encoder._sp_live
        if not sp:
            return h
        return _coll.unshard(h, self.mesh, (None, sp, None), summed=True)

    def _columns(self, x, w, b):
        """``x @ w + b`` in f32 for a weight and bias split on their
        columns over ``tp``: each rank's columns, gathered whole."""
        enc = self.encoder
        t = torch.matmul(enc._tp_in(x).float(), w.float()) + b.float()
        if enc._tp_live:
            t = _coll.unshard(t, self.mesh, (None,) * (t.dim() - 1)
                              + (enc._tp_live,))
        return t

    def encode(self, tokens, token_types):
        """tokens / token_types [B, S] int -> hidden [B, S, D] in the
        model dtype: the three embeddings summed, then
        ``TransformerLM.run_stack``.  Over a mesh: this rank's block of
        the global arrays (rows over ``dp``, positions over ``sp``)."""
        enc = self.encoder
        tokens, token_types = self._rows(tokens), self._rows(token_types)
        if enc._sp_live:
            tokens, token_types = (
                _coll.local_block(t, self.mesh, (None, enc._sp_live))
                for t in (tokens, token_types))
            pos = self.pos_embed[enc._positions(tokens.shape[1])]
        else:
            pos = self.pos_embed[:tokens.shape[1]][None]
        x = self.embed[tokens] + pos + self.type_embed[token_types]
        return enc.run_stack(x.to(self.cfg.dtype))

    def _pooled(self, h):
        return torch.tanh(self._columns(h[:, 0], self.pooler_w,
                                        self.pooler_b))

    def apply(self, tokens, token_types):
        """-> ``(hidden [B, S, D], pooled [B, D] f32)``: the sequence
        output and the tanh pooler over the first position (over ``sp``
        the output gathered whole: module doc)."""
        h = self._whole_seq(self.encode(tokens, token_types))
        return h, self._pooled(h)

    forward = apply

    def mlm_logits(self, hidden, positions):
        """Gather the masked positions [B, M] of ``hidden`` and read them
        out over the vocabulary with the TIED embedding matrix: an f32
        transform (``mlm_w``, ``mlm_b``, tanh-approximate GELU), the norm
        in the model dtype, then model-dtype operands with f32
        accumulation, plus the f32 ``mlm_bias_v``.  -> [B, M, V] f32."""
        positions = self._index(positions)
        B, M = positions.shape
        g = torch.gather(hidden, 1,
                         positions[..., None].expand(B, M, hidden.shape[-1]))
        t = F.gelu(self._columns(g, self.mlm_w, self.mlm_b),
                   approximate="tanh")
        t = _norm(t.to(self.cfg.dtype), self.mlm_norm)
        return (torch.matmul(t.float(), self.embed.float().t())
                + self.mlm_bias_v)

    # ---------------------------------------------------------------- loss
    def pretrain_loss(self, tokens, token_types, mlm_positions, mlm_labels,
                      mlm_weights, nsp_labels):
        """Masked-LM plus next-sentence loss (f32 scalar): the MLM cross
        entropy weighted by ``mlm_weights`` [B, M] over ``max(sum(w),
        1)``, plus the mean NSP cross entropy over ``nsp_labels`` [B].
        Over a mesh every rank passes the global batch; with ``dp`` or
        ``sp`` ranks each runs the heads on its rows (module doc) and the
        sums are summed over them before the divisions."""
        hidden = self._whole_seq(self.encode(tokens, token_types))
        if self.encoder._sp_live:
            hidden = _coll.local_block(hidden, self.mesh,
                                       (self.encoder._sp_live,))
        pooled = self._pooled(hidden)
        logits = self.mlm_logits(hidden,
                                 self._head_rows(self._index(mlm_positions)))
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, self._head_rows(
            self._index(mlm_labels))[..., None])[..., 0]
        w = self._head_rows(torch.as_tensor(mlm_weights,
                                            device=self.device).float())
        nsp_logits = (torch.matmul(pooled, self.nsp_w.float())
                      + self.nsp_b.float())
        nlogz = torch.logsumexp(nsp_logits, dim=-1)
        ngold = torch.gather(nsp_logits, -1, self._head_rows(
            self._index(nsp_labels))[..., None])[..., 0]
        batch = self._batch_live
        if not batch:
            mlm = ((logz - gold) * w).sum() / torch.clamp(w.sum(), min=1.0)
            return mlm + (nlogz - ngold).mean()
        num = _coll.psum(((logz - gold) * w).sum(), self.mesh, batch)
        den = _coll.psum(w.sum(), self.mesh, batch)
        nsp = _coll.psum((nlogz - ngold).sum(), self.mesh, batch)
        n = torch.as_tensor(nsp_labels).shape[0]
        return num / torch.clamp(den, min=1.0) + nsp / n
