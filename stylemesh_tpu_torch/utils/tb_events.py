"""TensorBoard event files without TensorFlow (counterpart of
``stylemesh_tpu/utils/tb_events.py``, a copy: the port imports nothing of
the JAX package).

The on-disk format written directly: a TFRecord stream of serialized
``Event`` protobufs (``events.out.tfevents.<ts>.<host>``). Scalars use
``Summary.Value.simple_value``, images ``Summary.Value.image`` with PNG
bytes, the subset TensorBoard's scalar and image dashboards read. Both
formats are stable public contracts:

- TFRecord framing: ``len(u64 LE) | masked_crc32c(len) | data |
  masked_crc32c(data)`` with the Castagnoli CRC and the
  ``((c >> 15 | c << 17) + 0xa282ead8)`` masking.
- Protobuf wire encoding of event.proto/summary.proto (field numbers
  hand-encoded below; varint + length-delimited + fixed64/fixed32).

    python -m stylemesh_tpu_torch.utils.tb_events <run>/metrics.jsonl
"""

import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


try:  # C implementation when present — the pure-Python byte loop below is
    # ~5 MB/s, which would stall the train loop on multi-MB image summaries
    import google_crc32c as _gcrc

    def _crc32c(data: bytes) -> int:
        return _gcrc.value(data)
except ImportError:
    def _crc32c(data: bytes) -> int:
        tab = _crc_table()
        c = 0xFFFFFFFF
        for b in data:
            c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
        return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field, v):
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field, v):
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field, v):
    return _key(field, 0) + _varint(int(v))


def _pb_bytes(field, data):
    return _key(field, 2) + _varint(len(data)) + data


def _pb_str(field, s):
    return _pb_bytes(field, s.encode("utf-8"))


def _event(step=None, wall_time=None, file_version=None, summary=None):
    msg = _pb_double(1, wall_time if wall_time is not None else time.time())
    if step is not None:
        msg += _pb_int(2, step)
    if file_version is not None:
        msg += _pb_str(3, file_version)
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag, value):
    val = _pb_str(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


def _image_summary(tag, png_bytes, h, w, channels):
    colorspace = {1: 1, 3: 3, 4: 4}[channels]
    img = (_pb_int(1, h) + _pb_int(2, w) + _pb_int(3, colorspace)
           + _pb_bytes(4, png_bytes))
    val = _pb_str(1, tag) + _pb_bytes(4, img)
    return _pb_bytes(1, val)


# --------------------------------------------------------------- writer

class TBEventWriter:
    """Append-only writer for one run directory (one event file)."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "host"
        path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(path, "ab")
        self.path = path
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, event_bytes):
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))

    def add_scalar(self, tag, value, step):
        self._write(_event(step=step, summary=_scalar_summary(tag, value)))

    def add_image(self, tag, img_hwc, step):
        """``img_hwc``: float array in [0, 1] or uint8, [H, W, C]."""
        import io

        from PIL import Image

        arr = np.asarray(img_hwc)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = arr[..., None]
        buf = io.BytesIO()
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[-1]]
        Image.fromarray(arr.squeeze() if mode == "L" else arr, mode).save(
            buf, format="PNG")
        self._write(_event(step=step, summary=_image_summary(
            tag, buf.getvalue(), arr.shape[0], arr.shape[1], arr.shape[-1])))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def convert_jsonl(jsonl_path, log_dir=None):
    """Convert an existing metrics.jsonl run log to a TB event file."""
    import json

    log_dir = log_dir or os.path.dirname(os.path.abspath(jsonl_path))
    w = TBEventWriter(log_dir)
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            w.add_scalar(rec["tag"], rec["value"], rec.get("step", 0))
    w.close()
    return w.path


if __name__ == "__main__":
    import sys

    print(convert_jsonl(sys.argv[1]))
