"""Builds the package's CUDA sources into shared libraries at first use.

The port's own copy of the idea in ``petastorm_tpu/native/build.py``: each
``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
plain-C shared library under ``petastorm_tpu_torch/_lib/``, keyed by a hash of
the source and the flags, and loaded with ``ctypes``.  Only the sources in the
checkout are used.  A missing toolkit or a failed build raises: a CUDA tensor
never falls back to the plain version.  ptxas's report (``-Xptxas -v``:
registers, shared memory and spills of each kernel) is kept beside each
library (:func:`ptxas_report`), and :func:`sass_instruction_counts` counts
each kernel's SASS instructions with the toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
LIB_DIR = os.path.join(_PKG_DIR, "_lib")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _report_path(path: str) -> str:
    return path[:-len(".so")] + ".ptxas.txt"


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
    # build to temporary names, then rename (the report first, so a library
    # never lacks it): concurrent builders race benignly
    with open(tmp + ".txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp + ".txt", _report_path(path))
    os.replace(tmp, path)
    return path


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (mangled name), what ptxas reported
    when it built the library: ``registers``, ``shared_bytes`` (static),
    ``spill_stores``, ``spill_loads`` and ``stack_bytes``."""
    with open(_report_path(build(name))) as f:
        text = f.read()
    out: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {}
            continue
        if kernel is None:
            continue
        facts = out[kernel]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            facts.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            facts["shared_bytes"] = int(m.group(1)) if m else 0
    return out


def sass_instruction_counts(name: str) -> Dict[str, int]:
    """SASS instructions of each kernel (mangled name) in ``csrc/<name>.cu``'s
    library, from ``cuobjdump -sass``; empty where the toolkit has no
    ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", build(name)], capture_output=True, text=True,
                          check=True).stdout
    counts: Dict[str, int] = {}
    kernel = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = 0
        elif kernel is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[kernel] += 1
    return counts


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
