"""Builds the port's host C++ libraries at first use.

The port's own copy of ``petastorm_tpu/native/build.py`` (its table of
libraries, ``:24-27``): ``g++`` compiles each source into a plain-C shared
library under the git-ignored ``petastorm_tpu_torch/_lib/``, keyed by a hash
of the source, the flags and the libraries it links, and ``ctypes`` loads it.

- ``jpeg_coef`` (``jpeg_coef.cpp``): the entropy half of the hybrid JPEG
  decode, linked against libjpeg;
- ``image_decode`` (``image_decode.cpp``): the batched host decode of PNG
  and JPEG columns, linked against libjpeg and libpng.

Headers: the libjpeg-turbo 6.2-ABI and libpng 1.6 headers vendored in
``include/`` (with their licenses), so a build needs no ``-dev`` package.
Libraries, linked by full path with an rpath: the machine's ``libjpeg.so.62``
and ``libpng16.so.16`` where there are such, else the ones Pillow's wheel
bundles (``pillow.libs/``).  Both libraries link the same libjpeg file, so a
process holds one copy of it.  ``jpeg_CreateDecompress`` checks the struct
size and ABI version, and ``png_create_read_struct`` the major and minor
version, at run time, so a mismatched library fails loudly.  A missing
``g++``, libjpeg or libpng, or a failed build, raises: nothing falls back.
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
from typing import Callable, Dict, Optional, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
INCLUDE_DIR = os.path.join(_DIR, "include")
LIB_DIR = os.path.join(os.path.dirname(_DIR), "_lib")

#: name -> (source file, the libraries it links, each found by ``find_<lib>``)
LIBS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "jpeg_coef": ("jpeg_coef.cpp", ("libjpeg",)),
    "image_decode": ("image_decode.cpp", ("libjpeg", "libpng")),
}

CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_SYSTEM_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64",
                    "/usr/lib", "/usr/local/lib")

_lock = threading.Lock()
_loaded: Dict[tuple, ctypes.CDLL] = {}


def _system_lib(soname: str) -> Optional[str]:
    for d in _SYSTEM_LIB_DIRS:
        path = os.path.join(d, soname)
        if os.path.exists(path):
            return path
    return None


def _pillow_lib(pattern: str) -> Optional[str]:
    """A library that Pillow's wheel bundles in ``pillow.libs/``, or None;
    found without importing Pillow."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    libs = os.path.join(os.path.dirname(list(spec.submodule_search_locations)[0]), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, pattern)))
    return found[0] if found else None


def pillow_libjpeg() -> Optional[str]:
    """The 6.2-ABI libjpeg that Pillow's wheel bundles, or None."""
    return _pillow_lib("libjpeg-*.so.62*")


def pillow_libpng() -> Optional[str]:
    """The libpng 1.6 that Pillow's wheel bundles, or None."""
    return _pillow_lib("libpng16-*.so.16*")


def find_libjpeg() -> str:
    """Path of the 6.2-ABI libjpeg to link: the machine's ``libjpeg.so.62``,
    else Pillow's bundled ``libjpeg-*.so.62*``; raises when there is neither."""
    path = _system_lib("libjpeg.so.62") or pillow_libjpeg()
    if path is None:
        raise RuntimeError(
            "no libjpeg.so.62 on this machine and no Pillow wheel bundling one; the native"
            " JPEG decode (host decode and the entropy half of decode_placement='device')"
            " cannot be built")
    return path


def find_libpng() -> str:
    """Path of the libpng 1.6 to link: the machine's ``libpng16.so.16``, else
    Pillow's bundled ``libpng16-*.so.16*``; raises when there is neither."""
    path = _system_lib("libpng16.so.16") or pillow_libpng()
    if path is None:
        raise RuntimeError(
            "no libpng16.so.16 on this machine and no Pillow wheel bundling one; the native"
            " image decode cannot be built")
    return path


def _linked(name: str, overrides: Dict[str, Optional[str]]) -> Dict[str, str]:
    """Absolute paths of the libraries ``name`` links: an override where one
    is given, else what ``find_<lib>`` finds."""
    finders = {"libjpeg": find_libjpeg, "libpng": find_libpng}
    return {lib: os.path.abspath(overrides.get(lib) or finders[lib]()) for lib in LIBS[name][1]}


def lib_path(name: str, linked: Dict[str, str]) -> str:
    """Where library ``name`` built against ``linked`` lives."""
    with open(os.path.join(_DIR, LIBS[name][0]), "rb") as f:
        key = f.read() + " ".join(CXX_FLAGS + [linked[lib] for lib in sorted(linked)]).encode()
    return os.path.join(LIB_DIR, f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so")


def build(name: str = "jpeg_coef", **libs: Optional[str]) -> str:
    """Compile library ``name`` (a key of :data:`LIBS`) if it is not built
    yet; returns its path.  ``libjpeg=``/``libpng=`` pick the files it links
    (default: :func:`find_libjpeg`, :func:`find_libpng`)."""
    linked = _linked(name, libs)
    path = lib_path(name, linked)
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH; the native library {name!r} cannot be built")
    os.makedirs(LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
    os.close(fd)
    source = os.path.join(_DIR, LIBS[name][0])
    rpaths = sorted({os.path.dirname(p) for p in linked.values()})
    cmd = [cxx, *CXX_FLAGS, "-I", INCLUDE_DIR, source, "-o", tmp, *linked.values(),
           *(f"-Wl,-rpath,{d}" for d in rpaths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {LIBS[name][0]}:\n{proc.stderr}")
    # build to a temporary name, then rename: concurrent builders race benignly
    os.replace(tmp, path)
    return path


def load(name: str, configure: Callable[[ctypes.CDLL], None],
         **libs: Optional[str]) -> ctypes.CDLL:
    """Build (if needed), load and configure library ``name``, once per
    process and choice of linked libraries (``libs`` as for :func:`build`;
    unset ones are looked up at the first call)."""
    key = (name, tuple(sorted(libs.items())))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(name, **libs))
            configure(lib)
            _loaded[key] = lib
        return lib
