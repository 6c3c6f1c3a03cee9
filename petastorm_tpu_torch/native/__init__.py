"""Host C++ of the port, built with g++ at first use and bound with ctypes:
the entropy half of the hybrid JPEG decode (``jpeg_coef.cpp``, ``image.py``),
the batched host decode (``image_decode.cpp``) and the process pool's
shared-memory arena (``shm_arena.cpp``, :class:`SharedArena` below).

:class:`SharedArena` is the port's copy of ``petastorm_tpu/native/__init__.py:
38-233``: one POSIX shared-memory segment and the C allocator over it.  The
process pool's workers copy (or decode) result columns into it once and the
consumer wraps them as numpy arrays with no further copy
(``native/transport.py``).  Where the JAX package quietly falls back to plain
queues when the library does not build, the port raises: :func:`load_arena`
is called when a process pool is made.
"""

from __future__ import annotations

import ctypes
import logging
import sys
import threading
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

logger = logging.getLogger(__name__)


def _configure_arena(lib: ctypes.CDLL) -> None:
    lib.psa_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.psa_init.restype = ctypes.c_int
    lib.psa_check.argtypes = [ctypes.c_void_p]
    lib.psa_check.restype = ctypes.c_int
    lib.psa_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.psa_alloc.restype = ctypes.c_int64
    lib.psa_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.psa_free.restype = ctypes.c_int
    lib.psa_free_bytes.argtypes = [ctypes.c_void_p]
    lib.psa_free_bytes.restype = ctypes.c_uint64
    lib.psa_largest_free.argtypes = [ctypes.c_void_p]
    lib.psa_largest_free.restype = ctypes.c_uint64


def load_arena() -> ctypes.CDLL:
    """The arena library, built with g++ at first use; raises when it cannot
    be built, or when the interpreter lacks the PEP 688 buffer protocol the
    zero-copy leases rest on (Python < 3.12)."""
    if sys.version_info < (3, 12):
        raise RuntimeError(
            f"the shared-memory transport needs Python >= 3.12 (PEP 688 buffer"
            f" protocol for its zero-copy leases); this is {sys.version_info.major}."
            f"{sys.version_info.minor}")
    from petastorm_tpu_torch.native import build

    return build.load("shm_arena", _configure_arena)


def transport_availability() -> dict:
    """``{"available": bool, "reason": str}`` for the zero-copy transport
    (``petastorm_tpu/native/__init__.py:47``): the arena library builds and
    the interpreter has the PEP 688 buffer protocol.  The service client's
    hello log and its ``shm_ok`` flag read it."""
    try:
        load_arena()
    except Exception as exc:  # noqa: BLE001 - reported, not raised
        return {"available": False, "reason": f"{type(exc).__name__}: {exc}"}
    return {"available": True, "reason": "ok"}


def is_available() -> bool:
    """True when the zero-copy transport works here."""
    return transport_availability()["available"]


#: serializes the resource-tracker patch below: two concurrent attaches could
#: otherwise interleave save and restore and leave it installed for good
_ATTACH_LOCK = threading.Lock()


def attach_shared_memory(name: str) -> shared_memory.SharedMemory:
    """Attach an existing named segment without registering it with the
    resource tracker (``petastorm_tpu/native/__init__.py:89``): Python < 3.13
    registers attached segments too, and the tracker would then unlink the
    creator's segment when this process exits."""
    with _ATTACH_LOCK:
        orig_register = resource_tracker.register

        def _no_shm_register(rname, rtype):
            if rtype != "shared_memory":
                orig_register(rname, rtype)

        resource_tracker.register = _no_shm_register
        try:
            return shared_memory.SharedMemory(name=name, create=False)
        finally:
            resource_tracker.register = orig_register


class SharedArena:
    """One shared-memory segment and the C allocator over it.

    The consumer process calls :meth:`create`; workers :meth:`attach` by
    name.  Python's ``SharedMemory`` owns the segment's lifetime, the C
    library the allocation inside it.
    """

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._lib = load_arena()
        self._shm = shm
        self._owner = owner
        self._closed = False    # allocation disabled (close requested)
        self._unmapped = False  # segment actually unmapped
        self._base = ctypes.addressof(ctypes.c_char.from_buffer(shm.buf))

    @classmethod
    def create(cls, size_bytes: int, name: Optional[str] = None) -> "SharedArena":
        shm = shared_memory.SharedMemory(name=name, create=True, size=size_bytes)
        try:
            arena = cls(shm, owner=True)
        except BaseException:
            shm.close()
            shm.unlink()
            raise
        rc = arena._lib.psa_init(arena._base, shm.size)
        if rc != 0:
            arena._base = None
            shm.close()
            shm.unlink()
            raise RuntimeError(f"psa_init failed: {rc}")
        return arena

    @classmethod
    def attach(cls, name: str) -> "SharedArena":
        shm = attach_shared_memory(name)
        arena = cls(shm, owner=False)
        if not arena._lib.psa_check(arena._base):
            raise RuntimeError(f"shared arena {name!r} is not initialized")
        return arena

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def size(self) -> int:
        return self._shm.size

    @property
    def closed(self) -> bool:
        return self._closed

    def disown(self) -> None:
        """Give up unlinking the segment: :meth:`close` then only unmaps it,
        and it stays alive for the other processes attached to it (the warm
        cache tier's lifecycle, ``petastorm_tpu/native/__init__.py:159``)."""
        self._owner = False

    def close(self) -> None:
        """Unlink (if this process created it) and unmap the segment.  While
        zero-copy views are alive the unmap is deferred: allocation stops at
        once, and a later ``close()`` or ``__del__`` retries.  Call it once
        no process will attach any more."""
        if self._unmapped:
            return
        self._base = None  # ctypes.from_buffer holds an export on shm.buf
        self._closed = True
        if self._owner:
            # the name goes at once (the workers are gone); a mapping that
            # live views still hold stays valid until they die
            self._owner = False  # unlink exactly once
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        import gc

        gc.collect()
        try:
            self._shm.close()
        except BufferError:
            logger.debug("arena %s still has live views; deferring close", self._shm.name)
            return
        self._unmapped = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - never raise from gc
            pass

    def alloc(self, size: int) -> Optional[int]:
        """Payload offset, or None when no free block fits right now."""
        if self._closed:
            raise RuntimeError("arena is closed")
        off = self._lib.psa_alloc(self._base, size)
        if off == -2:
            raise RuntimeError("shared arena corrupted")
        return None if off < 0 else int(off)

    def free(self, offset: int) -> None:
        if self._closed:  # teardown reclaims everything
            return
        rc = self._lib.psa_free(self._base, offset)
        if rc != 0:
            raise RuntimeError(f"psa_free({offset}) failed: {rc}")

    def free_bytes(self) -> int:
        if self._closed:
            return 0
        return int(self._lib.psa_free_bytes(self._base))

    def largest_free(self) -> int:
        if self._closed:
            return 0
        return int(self._lib.psa_largest_free(self._base))

    def used_bytes(self) -> int:
        """Bytes not free (payloads and block headers) right now."""
        if self._closed:
            return 0
        return self.size - self.free_bytes()

    def view(self, offset: int, size: int) -> memoryview:
        """Writable view of a payload region (no ownership transfer)."""
        if self._closed:
            raise RuntimeError("arena is closed")
        return self._shm.buf[offset:offset + size]
