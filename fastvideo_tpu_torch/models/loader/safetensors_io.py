"""Safetensors reader and writer (no ``safetensors`` package needed).

The format: an 8-byte little-endian header length, a JSON header mapping
each name to its dtype, shape and byte range, then the raw little-endian
data. The reader memory-maps the file (copy-on-write, so tensors are
writable and the file is never modified) and returns CPU tensors that
share the mapped pages; bf16 is read as 16-bit words and viewed as bf16.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from collections.abc import Iterator

import numpy as np
import torch

_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_CODES = {v: k for k, v in _DTYPES.items()}
# numpy types with the same item size, for viewing the raw bytes
_NP_VIEW = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.float16: np.float16, torch.bfloat16: np.int16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}


def _read_header(path: str) -> tuple[dict, int]:
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def tensor_names(path: str) -> list[str]:
    """The tensor names of one file (its header alone is read)."""
    return list(_read_header(path)[0])


def load_file(path: str) -> dict[str, torch.Tensor]:
    """All tensors of one file, as CPU tensors over a memory map."""
    return dict(iterate_file(path))


def iterate_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    header, start = _read_header(path)
    data = np.memmap(path, dtype=np.uint8, mode="c")
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        raw = data[start + lo:start + hi].view(_NP_VIEW[dtype])
        t = torch.from_numpy(raw)
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        yield name, t.reshape(info["shape"])


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write tensors (any device, any strides) to one safetensors file."""
    header: dict = {}
    offset = 0
    items = []
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append((name, t))
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for _, t in items:
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            fh.write(t.numpy().tobytes())
    os.replace(tmp, path)


def find_safetensors_files(directory: str) -> list[str]:
    index_files = glob.glob(os.path.join(directory, "*.safetensors.index.json"))
    if index_files:
        with open(index_files[0]) as fh:
            index = json.load(fh)
        shards = sorted(set(index["weight_map"].values()))
        return [os.path.join(directory, s) for s in shards]
    files = sorted(glob.glob(os.path.join(directory, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"No safetensors files under {directory}")
    return files


def iterate_safetensors(directory: str
                        ) -> Iterator[tuple[str, torch.Tensor]]:
    for path in find_safetensors_files(directory):
        yield from iterate_file(path)


def load_json_config(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
