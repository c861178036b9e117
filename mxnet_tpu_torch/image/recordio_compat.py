"""Between ``mx.image``'s iterators and the RecordIO container
(counterpart of ``mxnet_tpu.image.recordio_compat``): a ``.rec`` file
opened through its ``.idx``, and a record as a labelled HWC image."""
from __future__ import annotations

import numpy as _np

from ..recordio import MXIndexedRecordIO, unpack, _decode_img


def open_indexed(path_imgrec):
    idx_path = path_imgrec[:-4] + ".idx" if path_imgrec.endswith(".rec") \
        else path_imgrec + ".idx"
    return MXIndexedRecordIO(idx_path, path_imgrec, "r")


def record_to_image(buf):
    """Record bytes -> ``(float32 label array, HWC uint8 image)``."""
    header, payload = unpack(buf)
    img = _decode_img(payload)
    if img.ndim == 2:
        img = img[:, :, None]
    return _np.atleast_1d(_np.asarray(header.label, _np.float32)), img
