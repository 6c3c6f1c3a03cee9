"""Builds the entropy half of the hybrid JPEG decode (``jpeg_coef.cpp``) at first use.

The port's own copy of ``petastorm_tpu/native/build.py`` for one library:
``g++`` compiles ``jpeg_coef.cpp`` into a plain-C shared library under the
git-ignored ``petastorm_tpu_torch/_lib/``, keyed by a hash of the source, the
flags and the libjpeg it links, and ``ctypes`` loads it.

Headers: the libjpeg-turbo 6.2-ABI headers vendored in ``include/`` (with
their license), so the build needs no ``-dev`` package.  Library, linked by
full path: the machine's ``libjpeg.so.62`` where there is one, else the
6.2-ABI libjpeg-turbo that Pillow's wheel bundles (``pillow.libs/``).
``jpeg_CreateDecompress`` checks the struct size and ABI version at run time,
so a mismatched library fails loudly.  A missing ``g++`` or libjpeg, or a
failed build, raises: the device decode route has no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "jpeg_coef.cpp")
INCLUDE_DIR = os.path.join(_DIR, "include")
LIB_DIR = os.path.join(os.path.dirname(_DIR), "_lib")

CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_SYSTEM_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64",
                    "/usr/lib", "/usr/local/lib")

_lock = threading.Lock()
_loaded: Dict[Optional[str], ctypes.CDLL] = {}


def find_libjpeg() -> str:
    """Path of the 6.2-ABI libjpeg to link: the machine's ``libjpeg.so.62``,
    else Pillow's bundled ``libjpeg-*.so.62*``; raises when there is neither."""
    for d in _SYSTEM_LIB_DIRS:
        path = os.path.join(d, "libjpeg.so.62")
        if os.path.exists(path):
            return path
    bundled = pillow_libjpeg()
    if bundled is not None:
        return bundled
    raise RuntimeError(
        "no libjpeg.so.62 on this machine and no Pillow wheel bundling one; the entropy"
        " half of decode_placement='device' cannot be built")


def pillow_libjpeg() -> Optional[str]:
    """The 6.2-ABI libjpeg that Pillow's wheel bundles, or None; found
    without importing Pillow."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    libs = os.path.join(os.path.dirname(list(spec.submodule_search_locations)[0]), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so.62*")))
    return found[0] if found else None


def lib_path(libjpeg: str) -> str:
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + [libjpeg]).encode()).hexdigest()
    return os.path.join(LIB_DIR, f"libjpeg_coef-{tag[:16]}.so")


def build(libjpeg: Optional[str] = None) -> str:
    """Compile ``jpeg_coef.cpp`` against ``libjpeg`` (default :func:`find_libjpeg`)
    if its library is not built yet; returns its path."""
    libjpeg = os.path.abspath(libjpeg or find_libjpeg())
    path = lib_path(libjpeg)
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the entropy half of"
                           " decode_placement='device' cannot be built")
    os.makedirs(LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-I", INCLUDE_DIR, SOURCE, "-o", tmp, libjpeg,
           f"-Wl,-rpath,{os.path.dirname(libjpeg)}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for jpeg_coef.cpp:\n{proc.stderr}")
    # build to a temporary name, then rename: concurrent builders race benignly
    os.replace(tmp, path)
    return path


def load(configure: Callable[[ctypes.CDLL], None],
         libjpeg: Optional[str] = None) -> ctypes.CDLL:
    """Build (if needed), load and configure the library, once per process
    and ``libjpeg`` (None: :func:`find_libjpeg`'s, looked up at the first call)."""
    with _lock:
        lib = _loaded.get(libjpeg)
        if lib is None:
            lib = ctypes.CDLL(build(libjpeg))
            configure(lib)
            _loaded[libjpeg] = lib
        return lib
