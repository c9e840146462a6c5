"""``.safetensors`` reader and writer on torch alone (port of
imagharmony_tpu/io/safetensors_io.py; the ``safetensors`` package is not
needed).

Format: an 8-byte little-endian header length, a JSON header ``{name:
{dtype, shape, data_offsets}, "__metadata__": {str: str}}`` padded with
spaces to a multiple of 8 bytes, then the tensors' raw little-endian bytes,
each at its offsets from the end of the header.
"""

from __future__ import annotations

import json
import struct

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_CODES = {v: k for k, v in _DTYPES.items()}


def read_header(f):
    """-> (header without metadata, metadata, offset of the data) of an open
    file positioned at its start."""
    (hlen,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(hlen))
    return header, header.pop("__metadata__", None) or {}, 8 + hlen


def load(path, device="cpu"):
    """-> ({name: tensor on ``device``}, metadata). Each record is read into a
    tensor of its own, so nothing aliases the file."""
    out = {}
    with open(path, "rb") as f:
        header, meta, base = read_header(f)
        for name, info in header.items():
            start, end = info["data_offsets"]
            dtype = _DTYPES[info["dtype"]]
            t = torch.empty(info["shape"], dtype=dtype)
            if t.numel() * t.element_size() != end - start:
                raise ValueError(f"{path}: {name} holds {end - start} bytes, its shape "
                                 f"{info['shape']} and dtype {info['dtype']} need "
                                 f"{t.numel() * t.element_size()}")
            f.seek(base + start)
            if f.readinto(t.view(-1).view(torch.uint8).numpy()) != end - start:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = t.to(device)
    return out, meta


def save(path, tensors, metadata=None):
    """tensors: {name: tensor on any device}; metadata: {str: str}, stored as
    strings. Returns the bytes written. One tensor at a time reaches the
    host."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().view(-1).view(torch.uint8).numpy())
    return 8 + len(hjson) + offset
