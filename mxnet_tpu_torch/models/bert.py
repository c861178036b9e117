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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from .transformer import TransformerLM, TransformerLMConfig, _norm

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

    ``device`` defaults to ``cuda:0`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  Parameters are created without
    gradients (``model.requires_grad_(True)`` switches them on)."""

    def __init__(self, config, device=None):
        super().__init__()
        self.cfg = config
        dev = resolve_device(device)
        enc = TransformerLM(config, device=dev)
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
        self.pooler_w = p(D, D)
        self.pooler_b = p(D)
        self.nsp_w = p(D, 2)
        self.nsp_b = p(2)
        # the MLM transform before the tied-embedding readout
        self.mlm_w = p(D, D)
        self.mlm_b = p(D)
        self.mlm_norm = p(D)
        self.mlm_bias_v = p(config.vocab_size, dtype=torch.float32)

    @property
    def device(self):
        return self.embed.device

    # -------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, seed=0):
        """Random weights from ``seed``, the reference's distribution:
        normal(0, 0.02) matrices, unit norm scales, zero biases."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ONES:
                prm.fill_(1.0)
            elif leaf in _ZEROS:
                prm.zero_()
            else:
                prm.copy_(torch.randn(prm.shape, generator=g,
                                      device=self.device,
                                      dtype=torch.float32) * 0.02)
        return self

    def param_specs(self):
        raise NotImplementedError(
            "BERT.param_specs (tensor-parallel shardings) is not ported: "
            "meshes over several devices come with the scale-out slice "
            "(ROADMAP queue 1, slice 14); the port trains on one device")

    # ------------------------------------------------------------- forward
    def _index(self, x):
        return self.encoder._as_index(x)

    def encode(self, tokens, token_types):
        """tokens / token_types [B, S] int -> hidden [B, S, D] in the
        model dtype: the three embeddings summed, then
        ``TransformerLM.run_stack``."""
        tokens, token_types = self._index(tokens), self._index(token_types)
        S = tokens.shape[1]
        x = (self.embed[tokens] + self.pos_embed[:S][None]
             + self.type_embed[token_types])
        return self.encoder.run_stack(x.to(self.cfg.dtype))

    def apply(self, tokens, token_types):
        """-> ``(hidden [B, S, D], pooled [B, D] f32)``: the sequence
        output and the tanh pooler over the first position."""
        h = self.encode(tokens, token_types)
        pooled = torch.tanh(torch.matmul(h[:, 0].float(),
                                         self.pooler_w.float())
                            + self.pooler_b.float())
        return h, pooled

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
        t = torch.matmul(g.float(), self.mlm_w.float()) + self.mlm_b.float()
        t = F.gelu(t, approximate="tanh")
        t = _norm(t.to(self.cfg.dtype), self.mlm_norm)
        return (torch.matmul(t.float(), self.embed.float().t())
                + self.mlm_bias_v)

    # ---------------------------------------------------------------- loss
    def pretrain_loss(self, tokens, token_types, mlm_positions, mlm_labels,
                      mlm_weights, nsp_labels):
        """Masked-LM plus next-sentence loss (f32 scalar): the MLM cross
        entropy weighted by ``mlm_weights`` [B, M] over ``max(sum(w),
        1)``, plus the mean NSP cross entropy over ``nsp_labels`` [B]."""
        hidden, pooled = self.apply(tokens, token_types)
        logits = self.mlm_logits(hidden, mlm_positions)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            self._index(mlm_labels)[..., None])[..., 0]
        w = torch.as_tensor(mlm_weights, device=self.device).float()
        mlm = ((logz - gold) * w).sum() / torch.clamp(w.sum(), min=1.0)
        nsp_logits = (torch.matmul(pooled, self.nsp_w.float())
                      + self.nsp_b.float())
        nlogz = torch.logsumexp(nsp_logits, dim=-1)
        ngold = torch.gather(nsp_logits, -1,
                             self._index(nsp_labels)[..., None])[..., 0]
        return mlm + (nlogz - ngold).mean()
