"""A latency-injecting, call-counting filesystem for remote-IO tests.

Copy of ``petastorm_tpu/test_util/latency_fs.py`` (pyarrow only).  It wraps
any pyarrow filesystem in a ``pyarrow.fs.FileSystemHandler`` that

* sleeps ``latency_s`` on every metadata call, open and file READ (the
  per-request cost of an object store);
* counts opens, reads and bytes (``LatencyStats``), so a test can count the
  ranged reads a rowgroup costs;
* fails the first N reads and/or the first N file opens with ``OSError``
  after sleeping, so ``io_retries`` is exercised on the rowgroup-read path
  and on the metadata-open path.

Being a ``PyFileSystem`` and not a ``LocalFileSystem``, readers treat it as
remote: ``pre_buffer`` and the one-read window (``io_window``) turn on and
``io_retries='auto'`` arms, with no network.  The wrapper pickles over a
picklable base filesystem; its counters are then per process.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import pyarrow as pa
import pyarrow.fs as pafs


class LatencyStats:
    """Thread-safe counters shared by every file the wrapper hands out."""

    def __init__(self):
        self._lock = threading.Lock()
        self.opens = 0
        self.reads = 0
        self.bytes_read = 0
        self.meta_calls = 0
        self.failures_injected = 0
        self.slept_s = 0.0

    def __getstate__(self):
        # picklable across the process-pool spawn boundary; the lock is
        # process-local and recreated on the other side
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def add(self, **deltas) -> None:
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def try_inject_failure(self, box) -> bool:
        """Atomically consume one injected failure from the shared countdown
        (``box`` is the handler's ``[remaining]`` list).  Without the lock,
        two thread-pool workers could both observe 1 and inject 2."""
        with self._lock:
            if box[0] <= 0:
                return False
            box[0] -= 1
            self.failures_injected += 1
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {"opens": self.opens, "reads": self.reads,
                    "bytes_read": self.bytes_read,
                    "meta_calls": self.meta_calls,
                    "failures_injected": self.failures_injected,
                    "slept_s": round(self.slept_s, 3)}


class _LatentFile:
    """Python file-object protocol over a pyarrow NativeFile, with per-read
    latency, counting, and optional injected failures.  Arrow's PythonFile
    serializes ReadAt as lock+seek+read, so per-call state here is safe
    under parquet's IO thread pool."""

    def __init__(self, raw, latency_s: float, stats: LatencyStats,
                 fail_reads_box):
        self._raw = raw
        self._latency = latency_s
        self._stats = stats
        self._fail_reads = fail_reads_box  # shared [remaining] list
        self.closed = False

    def _sleep(self):
        if self._latency > 0:
            time.sleep(self._latency)
            self._stats.add(slept_s=self._latency)

    def read(self, nbytes=None):
        self._sleep()
        if self._stats.try_inject_failure(self._fail_reads):
            raise OSError("injected transient remote failure (latency_fs)")
        data = self._raw.read(nbytes) if nbytes is not None else self._raw.read()
        self._stats.add(reads=1, bytes_read=len(data))
        return data

    def seek(self, offset, whence=0):
        return self._raw.seek(offset, whence)

    def tell(self):
        return self._raw.tell()

    def size(self):
        return self._raw.size()

    def readable(self):
        return True

    def writable(self):
        return False

    def seekable(self):
        # open_input_stream hands out non-seekable streams; reflect the
        # wrapped file so callers take their non-seekable branch up front
        try:
            return self._raw.seekable()
        except AttributeError:
            return True

    def flush(self):
        pass

    def close(self):
        if not self.closed:
            self.closed = True
            self._raw.close()


class LatentFilesystemHandler(pafs.FileSystemHandler):
    """Delegates every operation to ``base``, charging ``latency_s`` per
    metadata call / open / read (see module docstring)."""

    def __init__(self, base: pafs.FileSystem, latency_s: float = 0.02,
                 stats: Optional[LatencyStats] = None,
                 fail_first_reads: int = 0,
                 fail_first_opens: int = 0):
        self._base = base
        self._latency = latency_s
        self.stats = stats or LatencyStats()
        #: shared countdown: the first N read() calls across ALL files fail
        self._fail_reads = [int(fail_first_reads)]
        #: shared countdown: the first N file opens (input file OR stream)
        #: fail - exercises the metadata-open retry path, not just reads
        self._fail_opens = [int(fail_first_opens)]

    def _meta(self):
        if self._latency > 0:
            time.sleep(self._latency)
            self.stats.add(slept_s=self._latency)
        self.stats.add(meta_calls=1)

    # -- FileSystemHandler interface ------------------------------------------

    def get_type_name(self):
        return "latent"

    def __eq__(self, other):
        return isinstance(other, LatentFilesystemHandler) and \
            other._base == self._base

    def normalize_path(self, path):
        return self._base.normalize_path(path)

    def get_file_info(self, paths):
        self._meta()
        return self._base.get_file_info(paths)

    def get_file_info_selector(self, selector):
        self._meta()
        return self._base.get_file_info(selector)

    def create_dir(self, path, recursive):
        self._meta()
        self._base.create_dir(path, recursive=recursive)

    def delete_dir(self, path):
        self._meta()
        self._base.delete_dir(path)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self._meta()
        self._base.delete_dir_contents(path, missing_dir_ok=missing_dir_ok)

    def delete_root_dir_contents(self):
        self._meta()
        self._base.delete_dir_contents("/", accept_root_dir=True)

    def delete_file(self, path):
        self._meta()
        self._base.delete_file(path)

    def move(self, src, dest):
        self._meta()
        self._base.move(src, dest)

    def copy_file(self, src, dest):
        self._meta()
        self._base.copy_file(src, dest)

    def open_input_stream(self, path):
        self._meta()
        if self.stats.try_inject_failure(self._fail_opens):
            raise OSError(
                f"injected transient open failure (latency_fs): {path}")
        self.stats.add(opens=1)
        return pa.PythonFile(
            _LatentFile(self._base.open_input_stream(path), self._latency,
                        self.stats, self._fail_reads), mode="r")

    def open_input_file(self, path):
        self._meta()
        if self.stats.try_inject_failure(self._fail_opens):
            raise OSError(
                f"injected transient open failure (latency_fs): {path}")
        self.stats.add(opens=1)
        return pa.PythonFile(
            _LatentFile(self._base.open_input_file(path), self._latency,
                        self.stats, self._fail_reads), mode="r")

    def open_output_stream(self, path, metadata):
        self._meta()
        return self._base.open_output_stream(path, metadata=metadata)

    def open_append_stream(self, path, metadata):
        self._meta()
        return self._base.open_append_stream(path, metadata=metadata)


def latent_filesystem(base: Optional[pafs.FileSystem] = None,
                      latency_s: float = 0.02,
                      fail_first_reads: int = 0,
                      fail_first_opens: int = 0,
                      ) -> Tuple[pafs.FileSystem, LatencyStats]:
    """A ready-to-use latent filesystem over ``base`` (default: local).

    Returns ``(fs, stats)``; pass ``fs`` to ``make_reader(...,
    filesystem=fs)``.  With the process pool each spawned worker holds its
    own unpickled copy (separate counters/countdowns).
    """
    handler = LatentFilesystemHandler(base or pafs.LocalFileSystem(),
                                      latency_s=latency_s,
                                      fail_first_reads=fail_first_reads,
                                      fail_first_opens=fail_first_opens)
    return pafs.PyFileSystem(handler), handler.stats
