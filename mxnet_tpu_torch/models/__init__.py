"""Models of the port (counterpart of ``mxnet_tpu.models``)."""
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["TransformerLM", "TransformerLMConfig"]
