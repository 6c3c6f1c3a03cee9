"""URL -> filesystem resolution.

Counterpart of ``petastorm_tpu/fs.py``, whole.  Resolution order
(``get_filesystem_and_path``, ``:69-137``):

1. no scheme or ``file://`` -> ``LocalFileSystem``;
2. ``hdfs://`` with a configured HA nameservice -> the failover client of
   :mod:`petastorm_tpu_torch.hdfs`; otherwise on to
3. ``pyarrow.fs.FileSystem.from_uri`` (gs, s3, plain hdfs);
4. fsspec, imported at first use, wrapped in ``PyFileSystem(FSSpecHandler)``
   for any other scheme (``memory://``, ``dir::``, or ``gs://`` through
   gcsfs where pyarrow has no GCS support).

A scheme nothing can resolve, or whose package (fsspec, gcsfs, s3fs) is
missing, raises a ``PetastormTpuError`` naming what failed; it never falls
back to the local disk.  A ``filesystem=`` given by the caller is used as
is, with the path convention of ``from_uri`` for the URL's scheme
(``:84-93``: a bucket is part of the path, an HDFS authority is not).
``FilesystemFactory`` (``:160-186``) re-resolves the filesystem in a worker
from the URL and ``storage_options``, or hands back the caller's.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence, Tuple, Union
from urllib.parse import urlparse

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import PetastormTpuError

#: serializes memory:// open+read pairs (the underlying MemoryFile has ONE
#: process-global seek position; see _IsolatedOpenHandler)
_ISOLATED_OPEN_LOCK = threading.Lock()


class _IsolatedOpenHandler(pafs.FSSpecHandler):
    """FSSpecHandler subclass giving each ``open_input_*`` an INDEPENDENT
    stream (a BytesIO snapshot of the file), for fsspec filesystems whose
    opens share one file object/seek position (the memory:// singleton).
    Everything else behaves exactly like FSSpecHandler."""

    def __init__(self, inner: "pafs.FSSpecHandler"):
        super().__init__(inner.fs)

    def _snapshot(self, path):
        import io

        import pyarrow as pa

        with _ISOLATED_OPEN_LOCK:
            f = self.fs.open(path, "rb")
            f.seek(0)
            data = f.read()
        return pa.PythonFile(io.BytesIO(data), mode="r")

    def open_input_file(self, path):
        return self._snapshot(path)

    def open_input_stream(self, path):
        return self._snapshot(path)


logger = logging.getLogger(__name__)


def normalize_dir_url(url: str) -> str:
    """Strip trailing slashes from a dataset directory URL (fs_utils.py:231)."""
    if not isinstance(url, str):
        raise PetastormTpuError(f"Dataset URL must be a string, got {type(url)}")
    return url.rstrip("/") if url != "/" else url


def get_filesystem_and_path(url: str,
                            storage_options: Optional[dict] = None,
                            filesystem: Optional[pafs.FileSystem] = None,
                            ) -> Tuple[pafs.FileSystem, str]:
    """Resolve a dataset URL to (pyarrow FileSystem, path-within-fs)."""
    url = normalize_dir_url(url)
    parsed = urlparse(url)
    if filesystem is not None:
        # match FileSystem.from_uri's path convention per scheme: bucket-based
        # stores (s3/gs) prefix the bucket, while an hdfs authority is a
        # host/nameservice and is NOT part of the path
        if parsed.scheme == "hdfs":
            path = parsed.path
        elif parsed.scheme:
            path = parsed.netloc + parsed.path
        else:
            path = url
        return filesystem, path
    if parsed.scheme in ("", "file"):
        return pafs.LocalFileSystem(), (parsed.path or url)
    if parsed.scheme == "hdfs":
        # logical HA nameservices resolve through the failover client; plain
        # host[:port] authorities and unconfigured environments fall through to
        # pyarrow's native hdfs (libhdfs reads the cluster config itself).
        # A RESOLVED nameservice whose namenodes all refuse connections is a
        # real outage: HdfsConnectError propagates (libhdfs would not fare
        # better, and falling through would bury the cause).
        from petastorm_tpu_torch import hdfs as hdfs_ha

        namenodes = hdfs_ha.resolve_url_namenodes(url)
        if namenodes:
            return (hdfs_ha.connect_to_either_namenode(
                        namenodes, user=(storage_options or {}).get("user")),
                    parsed.path)
        logger.debug("%r is not a configured HA nameservice; using pyarrow"
                     " native hdfs", url)
    try:
        fs, path = pafs.FileSystem.from_uri(url)
        return fs, path
    except (OSError, ValueError, NotImplementedError) as exc:
        native_error = exc  # pa.ArrowInvalid subclasses ValueError
    try:
        import fsspec  # imported at first use; gcsfs/s3fs at fsspec.filesystem()

        fs = fsspec.filesystem(parsed.scheme, **(storage_options or {}))
        handler = pafs.FSSpecHandler(fs)
        if parsed.scheme == "memory":
            # fsspec's memory filesystem hands EVERY concurrent open the
            # same MemoryFile object - a shared seek position, so two pool
            # workers reading one parquet file corrupt each other's reads
            # (footer reads land mid-file: "magic bytes not found").  Real
            # object stores open independent streams; give memory:// the
            # same semantics by serving each open an independent BytesIO
            # view of the bytes (test-sized data by definition).
            handler = _IsolatedOpenHandler(handler)
        return pafs.PyFileSystem(handler), parsed.netloc + parsed.path
    except ImportError as missing:
        # a scheme whose package is not installed never falls back to the
        # local disk: the error names the missing package
        raise PetastormTpuError(
            f"Cannot resolve filesystem for {url!r}: pyarrow said"
            f" {native_error!r}; fsspec said {missing!r} (install the package it"
            " names to read this scheme)") from native_error
    except Exception as fsspec_error:
        raise PetastormTpuError(
            f"Cannot resolve filesystem for {url!r}: pyarrow said"
            f" {native_error!r}; fsspec said {fsspec_error!r}") from native_error


def get_filesystem_and_path_or_paths(
        url_or_urls: Union[str, Sequence[str]],
        storage_options: Optional[dict] = None,
        filesystem: Optional[pafs.FileSystem] = None,
) -> Tuple[pafs.FileSystem, Union[str, list]]:
    """Resolve one URL or a homogeneous list of URLs (fs_utils.py:199-228).

    All URLs in a list must share scheme+authority (they are read by one FS).
    """
    if isinstance(url_or_urls, str):
        return get_filesystem_and_path(url_or_urls, storage_options, filesystem)
    urls = list(url_or_urls)
    if not urls:
        raise PetastormTpuError("Empty URL list")
    schemes = {(urlparse(u).scheme, urlparse(u).netloc) for u in urls}
    if len(schemes) > 1:
        raise PetastormTpuError(f"URLs must share scheme and authority, got {schemes}")
    fs, first = get_filesystem_and_path(urls[0], storage_options, filesystem)
    paths = [first] + [get_filesystem_and_path(u, storage_options, fs)[1] for u in urls[1:]]
    return fs, paths


class FilesystemFactory:
    """Picklable callable re-resolving the filesystem in a worker process.

    Reference: the serializable ``filesystem_factory`` closure (fs_utils.py:42-196) -
    pyarrow filesystems themselves may hold unpicklable native handles.

    When the user supplied an explicit ``filesystem`` (one that cannot be
    re-derived from the URL - credentialed S3, in-memory/mock fs), it is carried
    along and handed back verbatim; such readers require a thread/serial pool
    unless the filesystem object itself pickles.
    """

    def __init__(self, url: str, storage_options: Optional[dict] = None,
                 filesystem: Optional[pafs.FileSystem] = None):
        self._url = normalize_dir_url(url)
        self._storage_options = storage_options
        self._filesystem = filesystem

    def __call__(self) -> pafs.FileSystem:
        if self._filesystem is not None:
            return self._filesystem
        return get_filesystem_and_path(self._url, self._storage_options)[0]

    @property
    def url(self) -> str:
        """The dataset URL this factory re-resolves in worker processes."""
        return self._url
