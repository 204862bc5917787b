"""Minimal, dependency-free safetensors reader and writer.

Replaces the reference's `axiom::io::safetensors::load` (used at every model
ctor, e.g. transcribe.hpp:62-64). Implemented directly against the format
spec (8-byte LE header length + JSON header + raw row-major data) so we do
not depend on torch or the `safetensors` package at inference time.

Reads return numpy arrays (zero-copy views over a single file read).
bfloat16 is handled via ml_dtypes when it is installed; without it, BF16
tensors are widened to float32 by bit shift (exact).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

try:  # optional: keeps BF16 tensors as bfloat16 arrays
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = None

_DTYPES: dict[str, np.dtype] = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
if _BF16 is not None:
    _DTYPES["BF16"] = _BF16

_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Load a .safetensors file into a dict of numpy arrays."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"Not a safetensors file (too short): {path}")
    (header_len,) = struct.unpack("<Q", data[:8])
    header_end = 8 + header_len
    if header_end > len(data):
        raise ValueError(f"Corrupt safetensors header in {path}")
    header = json.loads(data[8:header_end].decode("utf-8"))
    buf = np.frombuffer(data, dtype=np.uint8, offset=header_end)

    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None and info["dtype"] == "BF16":
            # no ml_dtypes: bfloat16 is the top half of a float32
            dtype = np.dtype("<u2")
        if dtype is None:
            raise ValueError(f"Unsupported safetensors dtype {info['dtype']} for {name}")
        begin, end = info["data_offsets"]
        nbytes = int(np.prod(info["shape"], dtype=np.int64)) * np.dtype(dtype).itemsize
        # validate before slicing: Python's negative-index slicing would
        # silently hand back a correctly-sized window of the WRONG bytes
        if not (0 <= begin <= end <= len(buf)) or end - begin != nbytes:
            raise ValueError(
                f"corrupt safetensors: tensor {name!r} data_offsets "
                f"[{begin}, {end}] invalid for shape {info['shape']} "
                f"{info['dtype']} (buffer {len(buf)} bytes)"
            )
        arr = buf[begin:end].view(dtype)
        if info["dtype"] == "BF16" and dtype == np.dtype("<u2"):
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(info["shape"])
    return out


def save_safetensors(
    tensors: dict[str, np.ndarray],
    path: str | Path,
    metadata: dict[str, str] | None = None,
) -> None:
    """Write a dict of numpy arrays as a .safetensors file: tensors in
    sorted key order, a compact JSON header, int8 and uint8 (quantized
    codes) kept as I8 and U8, any dtype without a safetensors name written
    as F32 — byte for byte what the reference's writer produces."""
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs: list[bytes] = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dt = _DTYPE_NAMES.get(arr.dtype)
        if dt is None:
            arr = arr.astype(np.float32)
            dt = "F32"
        blob = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape), "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for blob in blobs:
            f.write(blob)


__all__ = ["load_safetensors", "save_safetensors"]
