"""The data loader's host preprocessing in C++, bound with ctypes (port of
imagharmony_tpu/native/__init__.py).

``batch_preprocess`` resizes each image's shortest edge to ``out_size``
(PIL's antialiased bilinear filter), crops and normalizes, a batch across
threads, in ``kernels/csrc/image_ops.cpp``: the JAX package's
``csrc/image_ops.cpp`` with the same flags, so its bytes are the JAX
package's. The library builds with ``g++`` at first use into
``kernels/_build/`` (``kernels/build.load_host``). A build or load failure
raises with the compiler's message: unlike the JAX package, which falls
back to PIL without a toolchain, the port has no silent fallback.
``batch_preprocess_plain`` is the PIL version, what the C++ code is held
against.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

ABI_VERSION = 1


def load() -> ctypes.CDLL:
    """The built library (building it first if needed), its ABI checked."""
    from imagharmony_tpu_torch.kernels import build

    lib = build.load_host("image_ops")
    lib.image_ops_abi_version.restype = ctypes.c_int
    if lib.image_ops_abi_version() != ABI_VERSION:
        raise RuntimeError(f"image_ops ABI {lib.image_ops_abi_version()}, expected "
                           f"{ABI_VERSION}")
    return lib


def batch_preprocess(images, out_size, *, tops, lefts, mean, std, num_threads=0) -> np.ndarray:
    """Fused shortest-edge resize, crop and normalize of a batch.

    images: HWC uint8 arrays of any sizes; tops/lefts: the crop offsets in
    resized coordinates; (x / 255 - mean) / std. -> (N, out_size, out_size,
    3) float32. ``num_threads`` <= 0: one thread an image, at most the
    host's CPU count."""
    lib = load()
    n = len(images)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    images = [np.ascontiguousarray(im) for im in images]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in images])
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    tops_c = (ctypes.c_int * n)(*[int(t) for t in tops])
    lefts_c = (ctypes.c_int * n)(*[int(x) for x in lefts])
    mean_c = (ctypes.c_float * 3)(*[float(m) for m in mean])
    std_c = (ctypes.c_float * 3)(*[float(s) for s in std])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.batch_resize_crop_normalize(
        ptrs, shs, sws, ctypes.c_int(n), ctypes.c_int(out_size), tops_c, lefts_c, mean_c,
        std_c, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int(num_threads))
    return out


def batch_preprocess_plain(images, out_size, *, tops, lefts, mean, std) -> np.ndarray:
    """``batch_preprocess`` through PIL: its bilinear resize, crop, then the
    normalization in numpy (close to the C++ code, not bit for bit)."""
    from PIL import Image

    out = np.empty((len(images), out_size, out_size, 3), np.float32)
    for i, img in enumerate(images):
        im = Image.fromarray(img)
        w, h = im.size
        short = min(w, h)
        nw, nh = round(w * out_size / short), round(h * out_size / short)
        im = im.resize((nw, nh), Image.BILINEAR)
        im = im.crop((lefts[i], tops[i], lefts[i] + out_size, tops[i] + out_size))
        arr = np.asarray(im, np.float32) / 255.0
        out[i] = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return out
