"""Kernels of the port (counterpart of ``mxnet_tpu.ops``)."""
