"""``mx.recordio`` — the RecordIO container (counterpart of
``mxnet_tpu.recordio``; reference ``python/mxnet/recordio.py``):
``MXRecordIO`` (sequential), ``MXIndexedRecordIO`` (random access through
a ``.idx`` file of ``key\toffset`` lines), ``IRHeader``, ``pack`` /
``unpack`` and ``pack_img`` / ``unpack_img``.

The on-disk framing is dmlc's, as the reference's: each record is a
magic u32 ``0xced7230a``, a length u32 whose upper 3 bits are the
continuation flag (a payload past 2^29 bytes is split into parts), the
payload, and zero padding to 4 bytes; so files that Apache MXNet's
``im2rec`` or either package wrote read alike.  Image payloads are
PIL's JPEG or PNG where PIL imports, else the ``NPYF`` raw container
(``b"NPYF"`` + ``numpy.save``), as the reference writes them.

This is the pure-Python reader; the reference's native mmap twin
(``src/native/recordio.cc``) is not ported.
"""
from __future__ import annotations

import os
import struct
import threading
from collections import namedtuple

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential record reader/writer (reference: python/mxnet/recordio.py
    MXRecordIO over dmlc::RecordIOWriter)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.fhandle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fhandle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fhandle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("invalid flag %r" % (self.flag,))
        self.is_open = True

    def close(self):
        if self.is_open and self.fhandle:
            self.fhandle.close()
            self.is_open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fhandle.tell()

    def seek(self, pos):
        assert not self.writable
        self.fhandle.seek(pos)

    def _write_part(self, buf, cflag):
        lrec = (cflag << _LFLAG_BITS) | len(buf)
        self.fhandle.write(struct.pack("<II", _MAGIC, lrec))
        self.fhandle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fhandle.write(b"\x00" * pad)

    def write(self, buf):
        """Payloads >= 2^29 bytes split into continuation parts (dmlc
        recordio cflag: 0=whole, 1=start, 2=middle, 3=end)."""
        assert self.writable
        if len(buf) <= _LENGTH_MASK:
            self._write_part(buf, 0)
            return
        parts = [buf[i:i + _LENGTH_MASK]
                 for i in range(0, len(buf), _LENGTH_MASK)]
        for i, part in enumerate(parts):
            cflag = 1 if i == 0 else (3 if i == len(parts) - 1 else 2)
            self._write_part(part, cflag)

    def _read_part(self):
        header = self.fhandle.read(8)
        if len(header) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise IOError("invalid record magic 0x%x in %s"
                          % (magic, self.uri))
        cflag = lrec >> _LFLAG_BITS
        length = lrec & _LENGTH_MASK
        buf = self.fhandle.read(length)
        if len(buf) < length:
            raise IOError("truncated record in %s" % (self.uri,))
        pad = (4 - length % 4) % 4
        if pad:
            self.fhandle.read(pad)
        return cflag, buf

    def read(self):
        assert not self.writable
        cflag, buf = self._read_part()
        if buf is None:
            return None
        if cflag == 0:
            return buf
        if cflag != 1:
            raise IOError("record stream starts mid-continuation in %s"
                          % (self.uri,))
        parts = [buf]
        while True:
            cflag, part = self._read_part()
            if part is None:
                raise IOError("unterminated continuation record in %s"
                              % (self.uri,))
            parts.append(part)
            if cflag == 3:
                break
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a text .idx file of `key\\toffset` lines
    (reference: python/mxnet/recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        # random access is seek()+read() on ONE shared handle: the lock
        # keeps the pair atomic so concurrent decode workers
        # (io.decode_workers) can't interleave seeks and read garbled
        # records (the native mmap reader is stateless and needs none)
        self._read_lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.is_open and self.writable:
            self.fidx.close()
        super().close()

    def read_idx(self, idx):
        with self._read_lock:
            self.seek(self.idx[idx])
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload; multi-label goes in the payload prefix
    when header.flag > 0 (reference recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (tuple, list, _np.ndarray)):
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + s


def unpack(s):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image array into a record (reference: recordio.py pack_img
    via cv2; here PIL or raw-npy fallback — OpenCV is not a TPU-image dep)."""
    encoded = _encode_img(img, quality, img_fmt)
    return pack(header, encoded)


def unpack_img(s, iscolor=-1):
    header, payload = unpack(s)
    return header, _decode_img(payload, iscolor)


def _encode_img(img, quality, img_fmt):
    img = _np.asarray(img)
    try:
        from PIL import Image
        import io as _io
        mode = "RGB" if img.ndim == 3 else "L"
        pil = Image.fromarray(img.astype(_np.uint8), mode=mode)
        buf = _io.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        pil.save(buf, format=fmt, quality=quality)
        return buf.getvalue()
    except ImportError:
        # npy fallback container (self-describing, decode below)
        import io as _io
        buf = _io.BytesIO()
        _np.save(buf, img)
        return b"NPYF" + buf.getvalue()


def _decode_img(payload, iscolor=-1):
    if payload[:4] == b"NPYF":
        import io as _io
        return _np.load(_io.BytesIO(payload[4:]))
    try:
        from PIL import Image
        import io as _io
        img = Image.open(_io.BytesIO(payload))
        if iscolor == 0:
            img = img.convert("L")
        elif iscolor == 1:
            img = img.convert("RGB")
        return _np.asarray(img)
    except ImportError as e:
        raise RuntimeError(
            "image decode requires PIL (or NPYF-packed records)") from e
