"""URL -> filesystem resolution for local datasets.

Counterpart of ``petastorm_tpu/fs.py:69-186``, trimmed to plain paths and
``file://`` URLs, one or a list of them.  Remote stores (GCS, S3, HDFS, fsspec) are not part of this
package yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union
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


def get_filesystem_and_path_or_paths(
        url_or_urls: Union[str, Sequence[str]]) -> Tuple[pafs.FileSystem, Union[str, list]]:
    """Resolve one URL, or a list of URLs of one scheme and authority
    (``petastorm_tpu/fs.py:146``), to (LocalFileSystem, path or paths)."""
    if isinstance(url_or_urls, str):
        return get_filesystem_and_path(url_or_urls)
    urls = list(url_or_urls)
    if not urls:
        raise PetastormTpuError("Empty URL list")
    schemes = {(urlparse(u).scheme, urlparse(u).netloc) for u in urls}
    if len(schemes) > 1:
        raise PetastormTpuError(f"URLs must share scheme and authority, got {schemes}")
    fs, _ = get_filesystem_and_path(urls[0])
    return fs, [get_filesystem_and_path(u)[1] for u in urls]
