"""RecordIO: the packed-record container (the port of
``mxnet_tpu/recordio.py``).

``MXRecordIO``/``MXIndexedRecordIO``, ``IRHeader``, ``pack``/``unpack``,
``pack_img``/``unpack_img`` and ``img_from_payload``, on dmlc-core's
format (magic ``0xced7230a``, a 29-bit length, records padded to 4
bytes; an ``.idx`` sidecar of ``key\\toffset`` lines), byte for byte as
the JAX package writes it: a file written by either package reads in the
other.

Reads and writes go through ``librecordio`` (``src/recordio.cc``, built
at first use by ``base.load_native_lib``) when it loads, else through
the pure-Python twin of the same format; ``native()`` says which route
is live, and each reader's ``route`` which one it took.

``pack_img(img_fmt=".raw")`` stores the pixels unencoded (``MXRW``, u16
height and width, u8 channels, the bytes); JPEG and PNG payloads need
PIL, and without it they raise ``ImportError``.
"""
from __future__ import annotations

import ctypes
import io as _pyio
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "img_from_payload", "native"]

_MAGIC = 0xCED7230A
_UNLOADED = object()
_LIB = _UNLOADED        # set to None to force the pure-Python route


def _lib():
    """``librecordio`` with its argument types, or None (the twin)."""
    global _LIB
    if _LIB is _UNLOADED:
        from .base import load_native_lib
        lib = load_native_lib("librecordio")
        if lib is not None:
            lib.rio_open.restype = ctypes.c_void_p
            lib.rio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.rio_close.restype = None
            lib.rio_close.argtypes = [ctypes.c_void_p]
            lib.rio_write.restype = ctypes.c_int64
            lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
            lib.rio_read.restype = ctypes.c_int64
            lib.rio_read.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_char_p)]
            lib.rio_seek.restype = ctypes.c_int
            lib.rio_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.rio_tell.restype = ctypes.c_int64
            lib.rio_tell.argtypes = [ctypes.c_void_p]
            lib.rio_flush.restype = ctypes.c_int
            lib.rio_flush.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def native() -> bool:
    """True when reads and writes go through ``librecordio``."""
    return _lib() is not None


def _require_pil(what):
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{what} needs PIL (Pillow), which is not installed; raw "
            f"records (pack_img(img_fmt='.raw')) need no decoder") from None
    return Image


class MXRecordIO:
    """Sequential record reader or writer (``flag`` ``"r"`` or ``"w"``)."""

    def __init__(self, uri, flag):
        if flag not in ("r", "w"):
            raise ValueError(f"flag must be 'r' or 'w', got {flag!r}")
        self.uri = uri
        self.flag = flag
        self._native = None
        self._nlib = None
        self._fp = None
        self.is_open = False
        self.open()

    @property
    def route(self):
        """``"native"`` or ``"python"``: the route this file took."""
        return "native" if self._native is not None else "python"

    def open(self):
        lib = _lib()
        if lib is not None:
            h = lib.rio_open(os.fsencode(self.uri),
                             1 if self.flag == "w" else 0)
            if not h:
                raise IOError(f"cannot open {self.uri!r} ({self.flag})")
            self._native, self._nlib = h, lib
        else:
            self._fp = open(self.uri, "wb" if self.flag == "w" else "rb")
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        if self._native is not None:
            self._nlib.rio_close(self._native)
            self._native = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        self.is_open = False

    def reset(self):
        """Back to the start for another read pass."""
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tell(self):
        if self._native is not None:
            return int(self._nlib.rio_tell(self._native))
        return self._fp.tell()

    def write(self, buf):
        """Append one record."""
        if self.flag != "w":
            raise IOError(f"{self.uri!r} is not open for writing")
        self._write_pos(buf)

    def _write_pos(self, buf):
        if isinstance(buf, str):
            buf = buf.encode()
        if self._native is not None:
            pos = int(self._nlib.rio_write(self._native, buf, len(buf)))
            if pos < 0:
                raise IOError("record write failed")
            return pos
        pos = self._fp.tell()
        self._fp.write(struct.pack("<II", _MAGIC,
                                   len(buf) & ((1 << 29) - 1)))
        self._fp.write(buf)
        pad = (4 - (len(buf) & 3)) & 3
        if pad:
            self._fp.write(b"\x00" * pad)
        return pos

    def read(self):
        """The next record's bytes, or None at the end."""
        if self.flag != "r":
            raise IOError(f"{self.uri!r} is not open for reading")
        if self._native is not None:
            out = ctypes.c_char_p()
            n = int(self._nlib.rio_read(self._native, ctypes.byref(out)))
            if n == -1:
                return None
            if n < 0:
                raise IOError(f"corrupt record stream in {self.uri!r}")
            return ctypes.string_at(out, n)
        head = self._fp.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError(f"corrupt record stream in {self.uri!r}")
        size = lrec & ((1 << 29) - 1)
        data = self._fp.read(size)
        pad = (4 - (size & 3)) & 3
        if pad:
            self._fp.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Records by key through an ``.idx`` sidecar (``key\\toffset``
    lines; ``tools/im2rec`` writes the pair)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        pos = self.idx[idx]
        if self._native is not None:
            self._nlib.rio_seek(self._native, pos)
        else:
            self._fp.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        pos = self._write_pos(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


# ------------------------------------------------------------ pack format --
IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """``IRHeader`` + payload bytes.  An array label rides in front of
    the payload as float32s, ``flag`` = their count."""
    header = IRHeader(*header)
    if not np.isscalar(header.label):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + s


def unpack(s):
    """-> ``(IRHeader, payload bytes)``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


_RAW_MAGIC = b"MXRW"


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image into a record: ``".raw"`` unencoded,
    ``".jpg"``/``".png"`` through PIL."""
    img = np.asarray(img)
    if img_fmt.lower() == ".raw":
        a = np.ascontiguousarray(img, np.uint8)
        if a.ndim == 2:
            a = a[:, :, None]
        h, w, c = a.shape
        return pack(header, _RAW_MAGIC + struct.pack("<HHB", h, w, c)
                    + a.tobytes())
    image = _require_pil(f"pack_img(img_fmt={img_fmt!r})")
    buf = _pyio.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kw = {"quality": quality} if fmt == "JPEG" else {}
    image.fromarray(img).save(buf, format=fmt, **kw)
    return pack(header, buf.getvalue())


def img_from_payload(payload, iscolor=1):
    """A record's image payload (raw or encoded) as HWC uint8."""
    if payload[:4] == _RAW_MAGIC:
        h, w, c = struct.unpack("<HHB", payload[4:9])
        img = np.frombuffer(payload, np.uint8, h * w * c, 9).reshape(h, w, c)
        if iscolor and c == 1:
            img = np.repeat(img, 3, axis=2)
        elif not iscolor and c == 3:
            # ITU-R 601 luma, as PIL's convert("L") of an encoded record
            img = np.dot(img, np.array([0.299, 0.587, 0.114])) \
                .astype(np.uint8)[:, :, None]
        return img if img.shape[2] > 1 else img[:, :, 0]
    image = _require_pil("decoding a JPEG or PNG record")
    img = image.open(_pyio.BytesIO(payload))
    return np.asarray(img.convert("RGB" if iscolor else "L"))


def unpack_img(s, iscolor=1):
    """-> ``(IRHeader, HWC uint8 array)``; raw records skip the decoder."""
    header, payload = unpack(s)
    return header, img_from_payload(payload, iscolor)
