"""Flat fused-RNN parameter-blob layout (the port's own copy of
``mxnet_tpu.rnn._fused_layout``).

One walker for everything that touches the cuDNN-style packed parameter
vector (reference: src/operator/rnn-inl.h GetRnnParamSize +
python/mxnet/rnn/rnn_cell.py:600-640 FusedRNNCell._slice_weights): the
symbolic ``RNN`` op slices it at execution (ops/rnn.py), FusedRNNCell
packs/unpacks it by name, the parameter-shape rule sizes it, and the
FusedRNN initializer fills it region by region.

Layout: for each layer, for each direction — per-gate i2h weights
(H, in) then per-gate h2h weights (H, H); after ALL weights, the biases
in the same traversal order.  Layer 0 input width is the data width;
deeper layers see H * num_directions.
"""
from __future__ import annotations

GATES = {"rnn_relu": ("",), "rnn_tanh": ("",),
         "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}


def fused_rnn_regions(num_input, num_hidden, num_layers, mode,
                      bidirectional=False, prefix=""):
    """Yield (name, offset, shape, kind) for every slice of the blob.

    ``kind`` is one of i2h_weight/h2h_weight/i2h_bias/h2h_bias; ``name``
    follows the reference unpacked naming
    ``{prefix}{direction}{layer}_{i2h|h2h}{gate}_{weight|bias}``.
    """
    gates = GATES[mode]
    dirs = ("l", "r") if bidirectional else ("l",)
    h = num_hidden
    out = []
    off = 0
    for layer in range(num_layers):
        inp = num_input if layer == 0 else h * len(dirs)
        for d in dirs:
            for g in gates:
                out.append(("%s%s%d_i2h%s_weight" % (prefix, d, layer, g),
                            off, (h, inp), "i2h_weight"))
                off += h * inp
            for g in gates:
                out.append(("%s%s%d_h2h%s_weight" % (prefix, d, layer, g),
                            off, (h, h), "h2h_weight"))
                off += h * h
    for layer in range(num_layers):
        for d in dirs:
            for g in gates:
                out.append(("%s%s%d_i2h%s_bias" % (prefix, d, layer, g),
                            off, (h,), "i2h_bias"))
                off += h
            for g in gates:
                out.append(("%s%s%d_h2h%s_bias" % (prefix, d, layer, g),
                            off, (h,), "h2h_bias"))
                off += h
    return out, off


def fused_rnn_group_slices(num_input, num_hidden, num_layers, mode,
                           bidirectional=False):
    """Gate-stacked views of the blob, one record per (layer, direction):
    ``(i2h_w_off, i2h_w_shape, h2h_w_off, h2h_w_shape, i2h_b_off,
    h2h_b_off)`` with weight shapes ``(G*H, in)``/``(G*H, H)`` and biases
    ``(G*H,)``.  Valid because per-gate regions are contiguous in
    traversal order — this is what the executor (ops/rnn.py _rnn) slices,
    derived from the same walk as pack/unpack/init."""
    regions, _ = fused_rnn_regions(num_input, num_hidden, num_layers, mode,
                                   bidirectional)
    by_kind = {}
    for _, off, shape, kind in regions:
        by_kind.setdefault(kind, []).append((off, shape))
    g = len(GATES[mode])
    ndirs = 2 if bidirectional else 1
    out = []
    for grp in range(num_layers * ndirs):
        i2h = by_kind["i2h_weight"][grp * g:(grp + 1) * g]
        h2h = by_kind["h2h_weight"][grp * g:(grp + 1) * g]
        i2h_b = by_kind["i2h_bias"][grp * g:(grp + 1) * g]
        h2h_b = by_kind["h2h_bias"][grp * g:(grp + 1) * g]
        out.append((i2h[0][0], (g * num_hidden, i2h[0][1][1]),
                    h2h[0][0], (g * num_hidden, num_hidden),
                    i2h_b[0][0], h2h_b[0][0]))
    return out


def fused_rnn_param_size(num_input, num_hidden, num_layers, mode,
                         bidirectional=False):
    _, size = fused_rnn_regions(num_input, num_hidden, num_layers, mode,
                                bidirectional)
    return size


def fused_rnn_num_input(total_size, num_hidden, num_layers, mode,
                        bidirectional=False):
    """Invert fused_rnn_param_size for the data width (reference
    FusedRNNCell.unpack_weights derives num_input from the blob size)."""
    b = 2 if bidirectional else 1
    m = len(GATES[mode])
    h = num_hidden
    # total = b*m*h*(ni + h + 2) + (L-1)*b*m*h*(b*h + h + 2)
    ni = total_size // (b * m * h) - (num_layers - 1) * (b * h + h + 2) \
        - h - 2
    return ni
