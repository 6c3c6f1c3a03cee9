"""One ranged read a rowgroup on a remote filesystem.

Counterpart of ``petastorm_tpu/io_window.py``: ``rowgroup_span`` (``:41``)
gives the one contiguous byte span a rowgroup's needed column chunks occupy
(Parquet lays them out back to back), or None when the span is too large or
would read too many unneeded bytes; ``WindowedFile`` (``:76``) is a Python
file object over a pyarrow ``NativeFile`` that fetches such a span in ONE
read (``prefetch``) and serves the chunk reads that fall inside it from
memory, counting the raw reads it issues (``raw_reads``).  Wrapped back with
``pa.PythonFile`` for Parquet.  Arrow serializes ReadAt on a Python file as
lock + seek + read; the lock here also keeps an explicit ``prefetch`` safe
against Parquet's IO threads.  The worker counts the raw reads each
rowgroup cost (``Reader.io_stats()['reads_per_rowgroup']``; 1.0 when the
window covers it).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: never window a span larger than this (a single huge rowgroup should
#: stream through arrow's own chunked reads, not sit in one buffer)
MAX_WINDOW_BYTES = 256 * 1024 * 1024

#: skip the window when the contiguous span is this much larger than the
#: chunks actually needed (column-pruned reads of far-apart columns would
#: amplify bytes to save requests; let pre_buffer handle those)
MAX_SPAN_WASTE_RATIO = 1.5
MAX_SPAN_WASTE_BYTES = 8 * 1024 * 1024


def rowgroup_span(metadata, row_group: int,
                  columns: Optional[Sequence[str]] = None
                  ) -> Optional[Tuple[int, int, int]]:
    """(start, length, needed_bytes) of the byte span covering ``columns``
    of ``row_group`` (all columns when None/empty), or None when the span
    fails the amplification guards (see module docstring)."""
    rg = metadata.row_group(row_group)
    start = None
    end = None
    needed = 0
    wanted = set(columns) if columns else None
    for j in range(rg.num_columns):
        col = rg.column(j)
        if wanted is not None:
            # nested columns stamp 'a.b.c'; match the root name like arrow
            root = col.path_in_schema.split(".", 1)[0]
            if root not in wanted:
                continue
        lo = col.data_page_offset
        if col.dictionary_page_offset is not None:
            lo = min(lo, col.dictionary_page_offset)
        hi = lo + col.total_compressed_size
        needed += col.total_compressed_size
        start = lo if start is None else min(start, lo)
        end = hi if end is None else max(end, hi)
    if start is None:
        return None
    length = end - start
    if length > MAX_WINDOW_BYTES:
        return None
    if length > needed * MAX_SPAN_WASTE_RATIO + MAX_SPAN_WASTE_BYTES:
        return None
    return start, length, needed


class WindowedFile:
    """File-object protocol over a pyarrow ``NativeFile`` with an explicit
    one-read prefetch window and a raw-read counter."""

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()
        self._pos = 0
        self._size: Optional[int] = None
        self._win_start = 0
        self._win: bytes = b""
        #: ranged reads actually issued against the underlying file
        self.raw_reads = 0
        self.closed = False

    # -- window ---------------------------------------------------------------

    def prefetch(self, start: int, length: int) -> bool:
        """Fetch ``[start, start+length)`` in ONE raw read; subsequent reads
        inside the window are served from memory.  Replaces any previous
        window (rowgroups are read one at a time per worker)."""
        with self._lock:
            if (start >= self._win_start
                    and start + length <= self._win_start + len(self._win)):
                return True  # already covered
            try:
                self._inner.seek(start)
                buf = self._inner.read(length)
            except Exception:  # noqa: BLE001 - fall back to direct reads
                logger.debug("window prefetch failed", exc_info=True)
                return False
            self.raw_reads += 1
            self._win_start = start
            self._win = buf
            return True

    def discard_window(self) -> None:
        with self._lock:
            self._win = b""

    # -- python file protocol (what pa.PythonFile needs) ----------------------

    def read(self, nbytes: int = -1) -> bytes:
        with self._lock:
            if nbytes is None or nbytes < 0:
                self._inner.seek(self._pos)
                out = self._inner.read()
                self.raw_reads += 1
            else:
                lo = self._pos - self._win_start
                if 0 <= lo and lo + nbytes <= len(self._win):
                    out = self._win[lo:lo + nbytes]
                else:
                    self._inner.seek(self._pos)
                    out = self._inner.read(nbytes)
                    self.raw_reads += 1
            self._pos += len(out)
            return out

    def seek(self, offset: int, whence: int = 0) -> int:
        with self._lock:
            if whence == 0:
                self._pos = offset
            elif whence == 1:
                self._pos += offset
            elif whence == 2:
                self._pos = self._file_size() + offset
            else:
                raise ValueError(f"bad whence {whence}")
            return self._pos

    def tell(self) -> int:
        return self._pos

    def _file_size(self) -> int:
        if self._size is None:
            self._size = self._inner.size()
        return self._size

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return True

    def flush(self) -> None:
        pass

    def close(self) -> None:
        with self._lock:
            if not self.closed:
                self.closed = True
                self._win = b""
                try:
                    self._inner.close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
