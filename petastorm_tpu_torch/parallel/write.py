"""Distributed (multi-process) dataset writes coordinated by ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel/write.py``: every process writes its
own part files, exactly one process stamps the metadata after a barrier, with
the failure semantics a multi-process job needs:

* barriers are ALWAYS reached (try/finally), so one process failing
  mid-phase cannot leave the others waiting in a barrier forever;
* a process whose write fails drops a ``_distributed_write_failed.<idx>``
  marker on the shared filesystem; process 0 refuses to stamp when any
  marker exists;
* every process verifies the metadata stamp before returning, so a failure
  anywhere surfaces as an exception everywhere, not as a silently
  short-rowed dataset.

No data moves between processes: each encodes and writes only the rows it
was handed.  Only the barrier rides the process group: the default
``sync_fn`` is ``torch.distributed.barrier`` on the default group (the JAX
package uses ``sync_global_devices``, ``:42``); without an initialized group,
process 0 of 1 needs no barrier.
"""

from __future__ import annotations

import json
import logging
import posixpath
from typing import Callable, Iterable, List, Optional

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.schema import Schema

logger = logging.getLogger(__name__)

#: underscore prefix keeps markers out of data-file discovery (etl metadata
#: and parquet readers skip ``_*`` files)
_FAIL_MARKER = "_distributed_write_failed"
#: per-process geometry sidecars merged into the stamped contract by process 0
_GEOM_SIDECAR = "_image_geometries"


def _default_sync(tag: str) -> None:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    dist.barrier()


def distributed_write_dataset(url: str,
                              schema: Schema,
                              local_rows: Iterable[dict],
                              *,
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None,
                              sync_fn: Optional[Callable[[str], None]] = None,
                              mode: str = "error",
                              **write_kwargs) -> List[str]:
    """Write THIS process's ``local_rows`` into a shared dataset; returns the
    part-file paths this process wrote (``petastorm_tpu/parallel/write.py:52``).

    Every participating process calls this with the same ``url``, ``schema``
    and ``mode`` and its own row slice (sharding the source is the caller's
    job, e.g. ``rows[rank::world_size]``).  Process 0 preflights the target
    per ``mode`` ('error' rejects a non-empty dataset directory, 'overwrite'
    clears it), stamps the dataset metadata once every process finished
    writing, and every process verifies the stamp before returning.

    ``process_index``/``process_count`` default to the ``torch.distributed``
    rank and world size (``(0, 1)`` without a group), ``sync_fn`` to a
    ``torch.distributed.barrier`` on the default group; pass them explicitly
    for another coordinator (tests use a ``threading.Barrier``).  Remaining
    ``write_kwargs`` go to ``etl.writer.write_dataset``.
    """
    from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata, write_dataset
    from petastorm_tpu_torch.fs import get_filesystem_and_path
    from petastorm_tpu_torch.parallel.mesh import shard_options_from_torch

    if process_index is None or process_count is None:
        process_index, process_count = shard_options_from_torch()
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range"
                         f" [0, {process_count})")
    if mode not in ("error", "overwrite"):
        raise ValueError(f"mode must be 'error' or 'overwrite', got {mode!r}"
                         " (append would make a crashed-job rerun silently"
                         " double rows)")
    sync = sync_fn or _default_sync
    owned = {"file_prefix", "stamp_metadata", "mode"} & set(write_kwargs)
    if owned:
        raise ValueError(f"{sorted(owned)} are owned by"
                         " distributed_write_dataset (per-host prefixes,"
                         " single-host stamp, coordinated mode handling)")
    fs, root = get_filesystem_and_path(url)

    # phase 1 - preflight (process 0 only): apply the mode contract and clear
    # stale failure markers while every other process waits
    preflight_error: Optional[BaseException] = None
    if process_index == 0:
        try:
            _preflight(fs, root, url, mode)
        except BaseException as exc:  # noqa: BLE001 - re-raised after barrier
            preflight_error = exc
            # peers check this marker after the barrier instead of writing
            # into a dirty or rejected target and waiting at the next barrier
            _drop_fail_marker(fs, root, "preflight")
    peer_error: Optional[BaseException] = None
    try:
        sync("petastorm_tpu:distributed_write:preflight")
        if process_index != 0:
            # the marker check must not raise past the next barrier: a
            # transient filesystem error on one process would strand the rest
            try:
                marker = fs.get_file_info(
                    posixpath.join(root, f"{_FAIL_MARKER}.preflight")
                    ).type == pafs.FileType.File
            except Exception as exc:  # noqa: BLE001 - surfaced after barrier
                peer_error = PetastormTpuError(
                    f"distributed write to {url!r}: could not check the"
                    f" preflight marker: {exc}")
            else:
                if marker:
                    peer_error = PetastormTpuError(
                        f"distributed write to {url!r} aborted: preflight"
                        " failed on host 0 (see its log)")
        # second barrier: every process has now observed (or not) the
        # preflight marker, so process 0 can remove it before raising
        sync("petastorm_tpu:distributed_write:preflight-observed")
    finally:
        if preflight_error is not None:
            _clear_fail_marker(fs, root, "preflight")
            raise preflight_error  # noqa: B012
        if peer_error is not None:
            raise peer_error  # noqa: B012

    # phase 2 - every process writes its own part files.  A failed process
    # drops a marker and keeps taking part in the remaining barriers.
    files: List[str] = []
    write_error: Optional[BaseException] = None
    geom_seen: dict = {}
    try:
        files = write_dataset(url, schema, local_rows,
                              file_prefix=f"part-{process_index:05d}",
                              stamp_metadata=False, mode="append",
                              geometry_sink=geom_seen,
                              **write_kwargs)
        if any(geom_seen.values()):
            # each process saw only its rows' image shapes; publish them as an
            # underscore sidecar so process 0 stamps the merged contract
            _write_geometry_sidecar(fs, root, process_index, geom_seen)
    except BaseException as exc:  # noqa: BLE001 - re-raised after barriers
        write_error = exc
        _drop_fail_marker(fs, root, process_index)
    sync("petastorm_tpu:distributed_write:data")

    # phase 3 - process 0 stamps, unless any process reported failure
    if process_index == 0 and write_error is None:
        try:
            markers = [f.path for f in fs.get_file_info(
                           pafs.FileSelector(root, recursive=False))
                       if posixpath.basename(f.path).startswith(_FAIL_MARKER)]
            if markers:
                raise PetastormTpuError(
                    f"write failed on host(s) {sorted(markers)}; dataset not"
                    " stamped")
            merged_geoms, sidecars = _merge_geometry_sidecars(fs, root)
            stamp_dataset_metadata(url, schema, geometries=merged_geoms or None)
            # only after the stamp succeeded: a failed stamp leaves the
            # sidecars behind so a retry still has the observed geometries
            _delete_geometry_sidecars(fs, sidecars)
        except BaseException as exc:  # noqa: BLE001 - surfaced by phase 4
            logger.error("distributed write stamp failed: %s", exc)
    sync("petastorm_tpu:distributed_write:stamp")
    if write_error is not None:
        raise write_error

    # phase 4 - every process verifies the stamp
    meta_path = posixpath.join(root, "_common_metadata")
    if fs.get_file_info(meta_path).type != pafs.FileType.File:
        raise PetastormTpuError(
            f"distributed write to {url!r} failed: metadata was not stamped"
            " (a host's write or the stamp raised; see host 0's log)")
    logger.info("host %d/%d wrote %d part file(s) to %s",
                process_index, process_count, len(files), url)
    return files


def _preflight(fs: pafs.FileSystem, root: str, url: str, mode: str) -> None:
    from petastorm_tpu_torch.etl.metadata import is_data_file

    info = fs.get_file_info(root)
    if info.type == pafs.FileType.Directory:
        entries = fs.get_file_info(pafs.FileSelector(root, recursive=True))
        data = [f.path for f in entries
                if f.type == pafs.FileType.File and is_data_file(f.path)]
        if data and mode == "error":
            raise PetastormTpuError(
                f"Dataset path {url!r} already contains {len(data)} data"
                " file(s); pass mode='overwrite' to replace")
        if data or any(posixpath.basename(f.path).startswith(_FAIL_MARKER)
                       for f in entries if f.type == pafs.FileType.File):
            fs.delete_dir_contents(root)
    fs.create_dir(root, recursive=True)


def _write_geometry_sidecar(fs: pafs.FileSystem, root: str, idx: int,
                            geom_seen: dict) -> None:
    payload = json.dumps({name: sorted(list(s) for s in shapes)
                          for name, shapes in geom_seen.items() if shapes})
    with fs.open_output_stream(
            posixpath.join(root, f"{_GEOM_SIDECAR}.{idx}.json")) as f:
        f.write(payload.encode())


def _merge_geometry_sidecars(fs: pafs.FileSystem, root: str) -> tuple:
    """(union of every process's geometry sidecar, the sidecar paths)."""
    merged: dict = {}
    paths = [f.path for f in fs.get_file_info(
                 pafs.FileSelector(root, recursive=False))
             if posixpath.basename(f.path).startswith(_GEOM_SIDECAR)]
    for path in sorted(paths):
        with fs.open_input_file(path) as f:
            for name, shapes in json.loads(f.read()).items():
                merged.setdefault(name, set()).update(
                    tuple(int(d) for d in s) for s in shapes)
    return merged, paths


def _delete_geometry_sidecars(fs: pafs.FileSystem, paths) -> None:
    for path in paths:
        try:
            fs.delete_file(path)
        except Exception as exc:  # noqa: BLE001 - cleanup is best-effort
            logger.warning("could not remove geometry sidecar %s: %s",
                           path, exc)


def _drop_fail_marker(fs: pafs.FileSystem, root: str, idx) -> None:
    try:
        fs.create_dir(root, recursive=True)
        with fs.open_output_stream(
                posixpath.join(root, f"{_FAIL_MARKER}.{idx}")) as f:
            f.write(b"")
    except Exception as exc:  # noqa: BLE001 - marker is best-effort
        logger.warning("could not write failure marker: %s", exc)


def _clear_fail_marker(fs: pafs.FileSystem, root: str, idx) -> None:
    try:
        fs.delete_file(posixpath.join(root, f"{_FAIL_MARKER}.{idx}"))
    except Exception as exc:  # noqa: BLE001 - cleanup is best-effort
        logger.warning("could not remove failure marker: %s", exc)
