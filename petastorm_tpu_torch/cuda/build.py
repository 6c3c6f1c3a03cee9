"""Builds the package's CUDA sources into shared libraries at first use.

The port's own copy of the idea in ``petastorm_tpu/native/build.py``: each
``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
plain-C shared library under ``petastorm_tpu_torch/_lib/``, keyed by a hash of
the source and the flags, and loaded with ``ctypes``.  Only the sources in the
checkout are used.  A missing toolkit or a failed build raises: a CUDA tensor
never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
LIB_DIR = os.path.join(_PKG_DIR, "_lib")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the CUDA"
            " kernels of petastorm_tpu_torch cannot be built on this machine")
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(SOURCE_DIR, f"{name}.cu"), "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(LIB_DIR, f"lib{name}-{tag}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is not built yet; returns its path."""
    path = lib_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, os.path.join(SOURCE_DIR, f"{name}.cu"), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    # build to a temporary name, then rename: concurrent builders race benignly
    os.replace(tmp, path)
    return path


def load(name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed), load and configure ``csrc/<name>.cu``'s library, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            configure(lib)
            _loaded[name] = lib
        return lib


def sources() -> List[str]:
    """Names of every ``csrc/*.cu`` source."""
    return sorted(f[:-3] for f in os.listdir(SOURCE_DIR) if f.endswith(".cu"))


def build_all() -> Dict[str, str]:
    """Build every source at once, one ``nvcc`` each; returns name -> library path."""
    from concurrent.futures import ThreadPoolExecutor

    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))
