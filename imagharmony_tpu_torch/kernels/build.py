"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with plain C entry points; the
sources share the Hopper helpers of ``csrc/sm90_tiles.cuh`` (TMA, mbarriers,
wgmma, the state kept per device). It is compiled with
``nvcc`` into a shared library under ``_build/`` (listed in ``.gitignore``),
named by a hash of the source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one loads the cached library.
Only the sources in this directory are compiled; nothing is downloaded.

The host library of ``csrc/image_ops.cpp`` (the data loader's resize, crop
and normalize, ``native.py``) builds the same way with ``g++``
(``load_host``), into the same directory under the same naming scheme.

Nothing here runs at import time: the CPU tests import every module of the
package on machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a (not sm_90): the Hopper-only instructions the kernels use (wgmma)
# exist only for the "a" target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels need it")
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built. The
    name hashes the flags, the source and every header of ``csrc/`` (the
    sources include ``sm90_tiles.cuh``), so an edited header rebuilds too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(so: Path, compiler: str, flags, src: Path) -> ctypes.CDLL:
    """Compile ``src`` into the library ``so`` unless it is built, then load
    it. Raises RuntimeError with the compiler's stderr when the build
    fails."""
    import ctypes

    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed to build {src.name} (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with nvcc if its library is not built yet,
    then load it. Raises RuntimeError with nvcc's stderr when the build
    fails."""
    return _build(library_path(name), _nvcc(), NVCC_FLAGS, CSRC / f"{name}.cu")


# the JAX package's flags for csrc/image_ops.cpp (its native/__init__.py)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def host_library_path(name: str) -> Path:
    """Where the library for the host source ``csrc/<name>.cpp`` is (or will
    be) built, named by a hash of the compiler flags and the source."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    path = CSRC / f"{name}.cpp"
    digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with g++ if its library is not built yet,
    then load it. Raises RuntimeError with the compiler's stderr when the
    build fails (there is no fallback)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {name}.cpp needs it")
    return _build(host_library_path(name), gxx, GXX_FLAGS, CSRC / f"{name}.cpp")


def resource_usage(name: str) -> dict:
    """What ptxas reports for each kernel of ``csrc/<name>.cu``, from a
    compile with ``-Xptxas -v`` whose object file is thrown away:
    {kernel name with its template arguments: {"registers", "smem_bytes",
    "spill_bytes", "wgmma_serialized"}}, and "setmaxnreg_ignored": True for
    a kernel whose setmaxnreg ptxas dropped. "wgmma_serialized" is ptxas's
    C7515 or C7511 notice: it made the kernel's wgmma products wait for
    each other (C7515: other instructions write their accumulator inside
    the pipeline; C7511: the registers the pipeline needs do not fit).
    "setmaxnreg_ignored" is its warning that it could not tell a
    warpgroup's register count (a warning that names no function counts
    against every kernel of the source). Both cost speed,
    not correctness."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "out.o"),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{proc.stderr}")
        filt = shutil.which("c++filt")
        text = proc.stderr
        if filt:
            text = subprocess.run([filt], input=text, capture_output=True, text=True).stdout

    def short(fn):  # demangled: name<args>(
        found = re.search(r"\w+(?:<[^>]*>)?(?=\()", fn)
        return found[0] if found else fn.strip()

    serialized = {short(m[1])
                  for m in re.finditer(r"\(C751[15]\)[^\n]*function '([^']+)'", text)}
    ignored = [line for line in text.splitlines()
               if "setmaxnreg" in line and "ignored" in line]
    ignored_fns = {short(m[1]) for line in ignored for m in re.finditer(r"'([^']+)'", line)}
    ignored_all = bool(ignored) and not ignored_fns  # a warning that names no function
    usage = {}
    pattern = re.compile(
        r"Function properties for (?P<fn>.+)\n.*?(?P<store>\d+) bytes spill stores, "
        r"(?P<load>\d+) bytes spill loads\n.*?Used (?P<regs>\d+) registers"
        r"(?:.*?(?P<smem>\d+) bytes smem)?")
    for m in pattern.finditer(text):
        name = short(m["fn"])
        usage[name] = {"registers": int(m["regs"]), "smem_bytes": int(m["smem"] or 0),
                       "spill_bytes": int(m["store"]) + int(m["load"]),
                       "wgmma_serialized": name in serialized}
        if ignored_all or name in ignored_fns:
            usage[name]["setmaxnreg_ignored"] = True
    return usage
