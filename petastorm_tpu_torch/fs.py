"""URL -> filesystem resolution for local datasets.

Counterpart of ``petastorm_tpu/fs.py:69-186``, trimmed to plain paths and
``file://`` URLs.  Remote stores (GCS, S3, HDFS, fsspec) are not part of this
package yet.
"""

from __future__ import annotations

from typing import Tuple
from urllib.parse import urlparse

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import PetastormTpuError


def normalize_dir_url(url: str) -> str:
    """Strip trailing slashes from a dataset directory URL."""
    if not isinstance(url, str):
        raise PetastormTpuError(f"Dataset URL must be a string, got {type(url)}")
    return url.rstrip("/") if url != "/" else url


def get_filesystem_and_path(url: str) -> Tuple[pafs.FileSystem, str]:
    """Resolve a local path or ``file://`` URL to (LocalFileSystem, path)."""
    url = normalize_dir_url(url)
    parsed = urlparse(url)
    if parsed.scheme not in ("", "file"):
        raise PetastormTpuError(
            f"Only local paths and file:// URLs are supported, got {url!r}")
    return pafs.LocalFileSystem(), (parsed.path or url)
