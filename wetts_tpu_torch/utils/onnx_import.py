"""Dependency-free ONNX initializer reader.

The port's own copy of `wetts_tpu/utils/onnx_import.py`.

The reference's released runtime bundles carry the acoustic model as
`final.onnx` (wetts/cli/model.py:28, exported by wetts/vits/export_onnx.py).
This environment ships neither `onnx` nor `onnxruntime`, so extracting the
weights needs a reader for the small protobuf subset an ONNX file uses:

    ModelProto.graph            = field 7  (message)
    GraphProto.initializer      = field 5  (repeated TensorProto)
    TensorProto.dims            = field 1  (repeated int64)
    TensorProto.data_type       = field 2  (enum)
    TensorProto.float_data      = field 4  (repeated float, packed)
    TensorProto.int64_data      = field 7  (repeated int64, packed)
    TensorProto.name            = field 8  (string)
    TensorProto.raw_data        = field 9  (bytes)

The torchscript exporter names each initializer after the parameter's
state-dict key (e.g. ``enc_p.emb.weight``), so the extracted dict feeds
`utils/convert.py` directly. Weight norm is already folded in the export
(export_onnx.py:80-82 removes it), which the converter's fold-tolerant
paths accept.

Only initializers are read; graph nodes are skipped wholesale, so exporter
version differences in the op graph cannot break the import.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType values actually produced for model weights
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
}
# per-element field readers for the non-raw encodings
_REPEATED_FIELDS = {4: ("<f", np.float32), 7: ("<q", np.int64),
                    10: ("<d", np.float64), 13: ("<Q", np.uint64)}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    data_type = 1
    name = ""
    raw = None
    repeated: list = []
    repeated_field = None
    for field, wire, val in _fields(buf):
        if field == 1:  # dims (packed or unpacked int64)
            if wire == 0:
                dims.append(val)
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(d)
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 8 and wire == 2:
            name = val.decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field in _REPEATED_FIELDS:
            fmt, _np_t = _REPEATED_FIELDS[field]
            repeated_field = field
            if wire == 2:  # packed
                size = struct.calcsize(fmt)
                repeated.extend(
                    struct.unpack_from(fmt, val, off)[0]
                    for off in range(0, len(val), size))
            else:
                if wire == 0:
                    repeated.append(val)
                else:
                    repeated.append(struct.unpack(fmt, val)[0])
    np_dtype = _DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type "
                         f"{data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif repeated_field is not None:
        arr = np.asarray(repeated,
                         dtype=_REPEATED_FIELDS[repeated_field][1])
        arr = arr.astype(np_dtype, copy=False)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract {initializer_name: array} from an ONNX file."""
    with open(path, "rb") as f:
        model = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if name:
                        out[name] = arr
    return out
