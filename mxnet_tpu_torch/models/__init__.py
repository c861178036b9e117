"""Models of the port (counterpart of ``mxnet_tpu.models``).  SSD lives
in ``models.ssd`` (imported by name, as in the reference)."""
from .bert import BERT, BERTConfig, bert_base
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["TransformerLM", "TransformerLMConfig", "BERT", "BERTConfig",
           "bert_base"]
