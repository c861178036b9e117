"""``mx.contrib`` (counterpart of ``mxnet_tpu.contrib``): the symbolic-era
int8 quantization entry point (``contrib.quantization``) and the control-flow
functions at their reference location.  The reference's other contrib
subsystems (text, SVRG, ONNX, TensorBoard, TensorRT) are not ported."""
from . import quantization  # noqa: F401
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401

__all__ = ["quantization", "foreach", "while_loop", "cond"]
