"""Safetensors reader and writer over torch tensors (the port's copy of
ml_stable_diffusion_tpu/convert/native_io.py).

The format: an 8-byte little-endian header length, a JSON table of
``{name: {"dtype", "shape", "data_offsets"}}`` and the tensors' bytes with no
holes.  The writer lays the tensors out in descending-itemsize order, so
every offset is a multiple of its own itemsize, and pads the header to 8
bytes: its files are byte for byte the JAX package's for the same tensors.

- ``load_file``: the header is a few KB of JSON, parsed in Python with
  every byte span bounds-checked.  Tensors are copied out of one shared
  ``mmap``.  BF16 is read as int16
  and viewed as ``torch.bfloat16``: neither ``ml_dtypes`` nor
  ``safetensors`` is needed.  The F8 types raise.
- ``save_file``: torch tensors or numpy arrays.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

_ALIGN = 8

#: safetensors dtype -> (torch dtype, numpy dtype of the stored bytes)
_DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, np.int16),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U64": (torch.uint64, np.uint64), "U32": (torch.uint32, np.uint32),
    "U16": (torch.uint16, np.uint16), "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_UNSUPPORTED = ("F8_E4M3", "F8_E5M2")
_ST_NAME = {torch_dt: name for name, (torch_dt, _) in _DTYPES.items()}


def _to_torch(t) -> torch.Tensor:
    return t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(t))


def _parse_table(path: Path):
    """-> (data_offset, [(name, dtype_str, shape, begin, end)])."""
    size = path.stat().st_size
    with open(path, "rb") as f:
        if size < 8:
            raise ValueError(f"{path}: file too small for safetensors header")
        (header_len,) = struct.unpack("<Q", f.read(8))
        if header_len > size - 8:
            raise ValueError(f"{path}: header length out of bounds")
        header = json.loads(f.read(header_len))
    data_offset = 8 + header_len
    table = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt, shape = info["dtype"], tuple(info["shape"])
        begin, end = info["data_offsets"]
        if dt not in _DTYPES and dt not in _UNSUPPORTED:
            raise ValueError(f"{path}: unknown dtype {dt} for {name}")
        itemsize = 1 if dt in _UNSUPPORTED else np.dtype(_DTYPES[dt][1]).itemsize
        if not 0 <= begin <= end <= size - data_offset:
            raise ValueError(f"{path}: data_offsets out of bounds for {name}")
        if end - begin != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ValueError(f"{path}: byte span mismatch for {name}")
        table.append((name, dt, shape, begin, end))
    return data_offset, table


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a safetensors file -> {name: CPU tensor}."""
    path = Path(path)
    data_offset, table = _parse_table(path)
    out = {}
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    for name, dt, shape, begin, end in table:
        if dt in _UNSUPPORTED:
            raise ValueError(f"{path}: {name} is {dt}; the port reads no 8-bit floats")
        torch_dt, np_dt = _DTYPES[dt]
        arr = np.frombuffer(mm, dtype=np_dt, count=(end - begin) // np.dtype(np_dt).itemsize,
                            offset=data_offset + begin).reshape(shape)
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch_dt) if dt == "BF16" else t
    return out


def save_file(tensors: dict, path: str | Path, metadata: dict[str, str] | None = None) -> None:
    """Write a spec-compliant safetensors file from torch tensors or numpy
    arrays."""
    path = Path(path)
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = {n: _to_torch(t).contiguous() for n, t in tensors.items()}
    for n, t in arrays.items():
        if t.dtype not in _ST_NAME:
            raise ValueError(f"unsupported dtype {t.dtype} for {n}")
    order = sorted(arrays, key=lambda n: (-arrays[n].element_size(), n))
    offset = 0
    for name in order:
        t = arrays[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAME[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-(8 + len(blob))) % _ALIGN)  # 8-align the data section
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = arrays[name]
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
