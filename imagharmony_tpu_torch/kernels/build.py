"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with plain C entry points; the
sources share the Hopper helpers of ``csrc/sm90_tiles.cuh`` (TMA, mbarriers,
wgmma, the state kept per device). It is compiled with
``nvcc`` into a shared library under ``_build/`` (listed in ``.gitignore``),
named by a hash of the source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one loads the cached library.
Only the sources in this directory are compiled; nothing is downloaded.

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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, then load
    it. Raises RuntimeError with nvcc's stderr when the build fails."""
    import ctypes

    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(so))


def resource_usage(name: str) -> dict:
    """What ptxas reports for each kernel of ``csrc/<name>.cu``, from a
    compile with ``-Xptxas -v`` whose object file is thrown away:
    {kernel name with its template arguments: {"registers", "smem_bytes",
    "spill_bytes", "wgmma_serialized"}}. The last is ptxas's C7515 notice:
    it made the kernel's wgmma products wait for each other (for instance
    because other instructions write their accumulator inside the
    pipeline), which costs speed, not correctness."""
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

    serialized = {short(m[1]) for m in re.finditer(r"\(C7515\)[^\n]*function '([^']+)'", text)}
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
    return usage
