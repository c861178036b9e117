"""Contrib recurrent cells (counterpart of ``mxnet_tpu.gluon.contrib.rnn``;
reference: python/mxnet/gluon/contrib/rnn/):
convolutional RNN/LSTM/GRU cells, variational (locked) dropout, LSTMP."""
from ...rnn import (RecurrentCell, HybridRecurrentCell)  # noqa: F401
from .conv_cells import (  # noqa: F401
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell,
    VariationalDropoutCell, LSTMPCell)

__all__ = ["RecurrentCell", "HybridRecurrentCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]
