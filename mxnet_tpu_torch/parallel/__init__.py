"""Parallel attention (counterpart of ``mxnet_tpu.parallel``); this slice
carries only the single-device plain lowering."""
