"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``gtsfm_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/gtsfm_tpu_torch/`` at the repository root (the
file name carries a hash of the source, of every ``csrc/*.cuh`` header and
of the flags, so an edited kernel or header rebuilds) and loaded with
``ctypes``. Kernels that use TMA reach the driver's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint*`` at run time,
so the build needs the toolkit's own headers only (no ``-lcuda``). Nothing is compiled at import time: the CPU tests
import every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gtsfm_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# name -> {"path", "seconds", "ptxas"} for every library built or loaded in
# this process (seconds = 0.0 when an up-to-date build was reused).
BUILD_LOG: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def toolkit_binary(tool: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): on PATH or under
    $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which(tool)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", tool)
    if os.path.exists(cand):
        return cand
    raise RuntimeError(f"{tool} not found: the CUDA toolkit is needed to build the port's kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_LOG.setdefault(name, {"path": str(out), "seconds": 0.0, "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [toolkit_binary("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    BUILD_LOG[name] = {"path": str(out), "seconds": seconds,
                       "ptxas": (proc.stdout + proc.stderr).strip()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
