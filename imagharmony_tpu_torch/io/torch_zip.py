"""Reader of ``torch.save`` zip archives (``.bin`` / ``.pt``) that runs no
code from the file (port of the reading half of
imagharmony_tpu/io/torch_pickle.py).

A torch zip holds ``<root>/data.pkl``, a pickle whose tensors name their
storages by persistent id, and ``<root>/data/<key>``, each storage's raw
bytes. The unpickler here admits only the globals a tensor checkpoint
needs (torch's tensor and parameter rebuild functions, the storage classes
and ``collections.OrderedDict``) and refuses every other. One reader takes
the files ``torch.save`` writes (the reference's checkpoints, the port's
own) and those the JAX package's writer makes, whose pickle opcodes
``torch.load(weights_only=True)`` refuses.
"""

from __future__ import annotations

import collections
import pickle
import struct
import zipfile

import torch

_STORAGE_DTYPES = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


class _StorageType:
    """What the pickle's ``torch.<X>Storage`` global stands for: its dtype."""

    def __init__(self, dtype):
        self.dtype = dtype


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *_args):
    size, stride = tuple(size), tuple(stride)
    if len(size) != len(stride) or storage_offset < 0 or min(size + stride, default=0) < 0:
        raise pickle.UnpicklingError(f"tensor with offset {storage_offset}, size {size} and "
                                     f"stride {stride} rejected")
    if all(size):
        last = storage_offset + sum(s * (d - 1) for s, d in zip(stride, size))
        if last >= storage.numel():
            raise pickle.UnpicklingError(
                f"tensor view out of bounds: needs element {last}, its storage has "
                f"{storage.numel()} (offset {storage_offset}, size {size}, stride {stride})")
    view = storage.as_strided(size, stride, storage_offset)
    # a view of the whole storage is the tensor; a part is copied out, so it
    # does not keep the rest of its storage alive
    whole = storage_offset == 0 and view.numel() == storage.numel() and view.is_contiguous()
    return view if whole else view.clone()


def _rebuild_parameter(data, *_args):
    return data


_ALLOWED_GLOBALS = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("collections", "OrderedDict"): collections.OrderedDict,
}


def _read_storage(zf, raw, name, dtype):
    """The record ``name`` as a flat tensor of ``dtype``, read straight into
    the tensor from the file ``raw``, past the record's local header (the
    writers store records uncompressed)."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise pickle.UnpicklingError(f"record {name} is compressed")
    raw.seek(info.header_offset)
    local = raw.read(30)
    if local[:4] != b"PK\x03\x04":
        raise pickle.UnpicklingError(f"bad local header for {name}")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    raw.seek(info.header_offset + 30 + name_len + extra_len)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    flat = torch.empty(info.file_size // itemsize, dtype=dtype)
    if raw.readinto(flat.view(torch.uint8).numpy()) != flat.numel() * itemsize:
        raise pickle.UnpicklingError(f"record {name} runs past the end of the file")
    return flat


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, zf, raw, root):
        super().__init__(f)
        self.zf, self.raw, self.root, self.storages = zf, raw, root, {}

    def find_class(self, module, name):
        if (module, name) in _ALLOWED_GLOBALS:
            return _ALLOWED_GLOBALS[(module, name)]
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(_STORAGE_DTYPES[name])
        raise pickle.UnpicklingError(f"blocked global {module}.{name}")

    def persistent_load(self, pid):
        if not (isinstance(pid, tuple) and len(pid) == 5 and pid[0] == "storage"
                and isinstance(pid[1], _StorageType)):
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        _, storage_type, key, _location, numel = pid
        if key not in self.storages:
            flat = _read_storage(self.zf, self.raw, f"{self.root}data/{key}",
                                 storage_type.dtype)
            if flat.numel() < numel:
                raise pickle.UnpicklingError(f"storage {key} holds {flat.numel()} elements, "
                                             f"the pickle says {numel}")
            self.storages[key] = flat
        return self.storages[key]


def load(path):
    """A torch zip archive -> its object (nested dicts of CPU tensors)."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        pkl = next(n for n in zf.namelist() if n == "data.pkl" or n.endswith("/data.pkl"))
        root = pkl[: -len("data.pkl")]
        if f"{root}byteorder" in zf.namelist() and zf.read(f"{root}byteorder") != b"little":
            raise ValueError(f"{path}: big-endian archives are not read")
        with zf.open(pkl) as f:
            return _Unpickler(f, zf, raw, root).load()
