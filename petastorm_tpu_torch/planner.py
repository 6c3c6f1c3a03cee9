"""Plan-aware static pipeline planner: seed the tuning knobs before data flows.

The port's copy of ``petastorm_tpu/planner.py:59-510``: the same footer
summary, fingerprint, schema hash, knob heuristics and profile format, so
both packages plan the same knobs with the same provenance.

The autotune loop (petastorm_tpu_torch.autotune) is runtime hill-climbing: it
starts from static defaults and discovers the host's optimum one knob-move at
a time, which costs every COLD start a climb through the bad region.  This
module is the static pass before it:

* **Metadata pass** - one parquet footer read (:func:`footer_stats`) yields
  rowgroup byte sizes, per-column compressed/uncompressed spans and the
  compression codec for the fields actually read.  From the decode expansion
  ratio and rowgroup geometry the planner picks initial ``workers``,
  ``decode_threads``, ``results_queue``, ``prefetch`` and (for the shared
  warm tier) a ``cache_mem`` residency target that fits the estimated
  decoded dataset.
* **Flight profiles** - at reader stop, an autotuned reader persists its
  CONVERGED knob values plus the observed delivered rate as a small JSON
  profile beside the cache location (:class:`ProfileStore`; atomic
  tmp+rename writes).  Profiles are keyed by dataset fingerprint + schema
  hash, so a rewritten dataset or changed field selection never replays
  stale knobs; a corrupt or mismatched profile is tolerated with a warning
  and the planner falls back to the metadata pass.

``make_reader(autotune=True)`` (or ``workers_count='auto'``) runs the planner
automatically and STARTS from its :class:`PlanVerdict` - the runtime loop
then only fine-tunes.  Every knob carries provenance (``profile`` /
``metadata`` / ``default`` / ``pinned``) surfaced in
``Reader.diagnostics['planner']``.  ``AutotunePolicy(planner=False)``
disables the pass.  Profiles live under the port's warm-tier location
(``<tmp>/petastorm_tpu_torch_warm/profiles``) unless a ``cache_location``
is given.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)

#: profile schema version; a bump invalidates every persisted profile
PROFILE_VERSION = 1
#: subdirectory of the cache location holding the per-dataset profiles
PROFILE_DIRNAME = "profiles"
#: best-effort cap on persisted profiles per store (oldest swept first)
MAX_PROFILES = 64

#: knob provenance values, in trust order
SOURCES = ("pinned", "profile", "metadata", "default")


def default_profile_location() -> str:
    """Where profiles land when no ``cache_location`` is configured (the
    same host-wide default namespace the shared warm tier uses)."""
    from petastorm_tpu_torch.cache_shared import DEFAULT_LOCATION

    return DEFAULT_LOCATION


def dataset_fingerprint(info) -> str:
    """Content fingerprint of a dataset: root/url + file count + rowgroup
    count + total rows + (size, mtime) of the first and last data files.
    A dataset rewritten in place (or grown/shrunk) changes the fingerprint,
    so a profile recorded against the old bytes is simply never found -
    stale knobs cannot replay.  Best-effort on filesystems that cannot
    stat (the fingerprint then keys on structure alone)."""
    digest = hashlib.md5()
    digest.update(str(getattr(info, "url", "")).encode())
    files = sorted({rg.path for rg in info.row_groups})
    total_rows = sum(rg.num_rows for rg in info.row_groups)
    digest.update(f"|files:{len(files)}|rowgroups:{len(info.row_groups)}"
                  f"|rows:{total_rows}".encode())
    for path in files[:1] + files[-1:]:
        try:
            st = info.filesystem.get_file_info(path)
            digest.update(f"|{path}:{st.size}:{st.mtime_ns}".encode())
        except Exception:  # noqa: BLE001 - fingerprint is best-effort
            digest.update(f"|{path}:?".encode())
    return digest.hexdigest()


def schema_hash(read_fields: Sequence[str], transform_signature: str) -> str:
    """Hash of what the pipeline READS + the transform applied to it: a
    changed field selection or edited transform keys a different profile
    (its converged knobs tuned a different workload)."""
    digest = hashlib.md5()
    digest.update(",".join(read_fields).encode())
    digest.update(f"|tf:{transform_signature}".encode())
    return digest.hexdigest()[:16]


@dataclasses.dataclass
class PlannedKnob:
    """One planned knob value plus where it came from and why."""

    value: int
    #: 'pinned' (user set it explicitly - the planner never overrides),
    #: 'profile' (recorded flight history), 'metadata' (parquet footer
    #: heuristics), or 'default' (the static fallback)
    source: str
    why: str

    def to_dict(self) -> dict:
        """JSON-serializable knob entry (value/source/why)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanVerdict:
    """The static pass's output: knob -> :class:`PlannedKnob`, plus the
    inputs that produced it (footer summary, profile provenance) - latched
    into ``Reader.diagnostics['planner']``."""

    knobs: Dict[str, PlannedKnob]
    fingerprint: str
    schema_hash: str
    metadata: dict
    profile: Optional[dict] = None
    profile_path: Optional[str] = None
    #: the store to persist this run's converged knobs into at reader stop
    store: Optional["ProfileStore"] = None

    def to_dict(self) -> dict:
        """JSON-serializable verdict (diagnostics / --json output)."""
        return {
            "knobs": {name: knob.to_dict()
                      for name, knob in sorted(self.knobs.items())},
            "fingerprint": self.fingerprint,
            "schema_hash": self.schema_hash,
            "metadata": self.metadata,
            "profile": ({"written_at": self.profile.get("written_at"),
                         "observed_rows_per_sec":
                             self.profile.get("observed_rows_per_sec"),
                         "knobs": self.profile.get("knobs")}
                        if self.profile else None),
            "profile_path": self.profile_path,
        }


class ProfileStore:
    """Per-dataset flight-profile persistence beside the cache location.

    One small JSON file per (dataset fingerprint, schema hash); writes are
    atomic (temp file + rename - a reader crashing mid-write can never leave
    a half profile), loads tolerate corrupt/mismatched files with a warning
    (the planner then falls back to the metadata pass), and the store sweeps
    itself to :data:`MAX_PROFILES` entries by mtime.
    """

    def __init__(self, location: Optional[str] = None):
        self._dir = os.path.join(
            os.path.abspath(location or default_profile_location()),
            PROFILE_DIRNAME)

    @property
    def directory(self) -> str:
        """The profile directory (``<cache_location>/profiles``)."""
        return self._dir

    def path_for(self, fingerprint: str, schema_hash_: str) -> str:
        """Filename for one (dataset, read-shape) profile."""
        return os.path.join(
            self._dir, f"profile-{fingerprint[:16]}-{schema_hash_[:8]}.json")

    def load(self, fingerprint: str, schema_hash_: str) -> Optional[dict]:
        """The recorded profile, or None (missing / corrupt / stale -
        never raises; a bad profile must not fail reader construction)."""
        path = self.path_for(fingerprint, schema_hash_)
        try:
            with open(path) as f:
                profile = json.load(f)
        except FileNotFoundError:
            return None
        except Exception as exc:  # noqa: BLE001 - corrupt file tolerated
            logger.warning(
                "ignoring corrupt pipeline profile %s (%s); planning from"
                " parquet metadata only", path, exc)
            return None
        if (not isinstance(profile, dict)
                or profile.get("version") != PROFILE_VERSION
                or profile.get("fingerprint") != fingerprint
                or profile.get("schema_hash") != schema_hash_
                or not isinstance(profile.get("knobs"), dict)):
            logger.warning(
                "ignoring stale/mismatched pipeline profile %s (version/"
                "fingerprint/schema mismatch); planning from parquet"
                " metadata only", path)
            return None
        return profile

    def save(self, fingerprint: str, schema_hash_: str,
             payload: dict) -> Optional[str]:
        """Atomically persist ``payload``; returns the path (None on
        failure - persistence is an optimization, never an error)."""
        payload = dict(payload, version=PROFILE_VERSION,
                       fingerprint=fingerprint, schema_hash=schema_hash_)
        path = self.path_for(fingerprint, schema_hash_)
        try:
            os.makedirs(self._dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, sort_keys=True)
                os.replace(tmp, path)  # atomic publish: all or nothing
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            self._sweep()
            return path
        except Exception:  # noqa: BLE001 - best-effort persistence
            logger.warning("pipeline profile write failed for %s", path,
                           exc_info=True)
            return None

    def _sweep(self) -> None:
        """Bound the store: drop oldest profiles past :data:`MAX_PROFILES`
        and any crashed-writer ``.tmp`` orphans."""
        try:
            entries = []
            for name in os.listdir(self._dir):
                p = os.path.join(self._dir, name)
                try:
                    mtime = os.stat(p).st_mtime
                except OSError:
                    continue
                if name.endswith(".tmp"):
                    import time as _time

                    if _time.time() - mtime > 300:
                        try:
                            os.remove(p)
                        except OSError:
                            pass
                    continue
                entries.append((mtime, p))
            entries.sort()
            for _mtime, p in entries[:max(0, len(entries) - MAX_PROFILES)]:
                try:
                    os.remove(p)
                except OSError:
                    pass
        except OSError:
            pass


def footer_stats(info, read_fields: Sequence[str],
                 max_rowgroups: int = 32) -> dict:
    """Summarize one parquet footer (the first data file) for the fields
    actually read: per-rowgroup compressed/uncompressed byte spans, the
    decode expansion ratio, and per-column compression codecs.  One ranged
    footer read - cheap enough for every reader construction; any failure
    returns ``{}`` and the planner falls back to defaults."""
    import pyarrow.parquet as pq

    files = sorted({rg.path for rg in info.row_groups})
    if not files:
        return {}
    try:
        with info.filesystem.open_input_file(files[0]) as f:
            md = pq.ParquetFile(f).metadata
        tops = {str(field).split(".", 1)[0] for field in read_fields}
        comp_sum = unc_sum = 0
        columns: Dict[str, dict] = {}
        n = min(md.num_row_groups, max_rowgroups)
        for i in range(n):
            rg = md.row_group(i)
            for j in range(rg.num_columns):
                col = rg.column(j)
                top = col.path_in_schema.split(".", 1)[0]
                if tops and top not in tops:
                    continue
                comp_sum += col.total_compressed_size
                unc_sum += col.total_uncompressed_size
                entry = columns.setdefault(
                    top, {"compressed": 0, "uncompressed": 0,
                          "compression": str(col.compression)})
                entry["compressed"] += col.total_compressed_size
                entry["uncompressed"] += col.total_uncompressed_size
        if n == 0:
            return {}
        total_rowgroups = len(info.row_groups)
        return {
            "file": files[0],
            "files": len(files),
            "rowgroups_sampled": n,
            "rowgroups_total": total_rowgroups,
            "rows_total": sum(rg.num_rows for rg in info.row_groups),
            "avg_rowgroup_compressed_bytes": comp_sum // n,
            "avg_rowgroup_uncompressed_bytes": unc_sum // n,
            "expansion": (unc_sum / comp_sum) if comp_sum else 1.0,
            "est_dataset_uncompressed_bytes":
                (unc_sum // n) * total_rowgroups,
            "columns": columns,
        }
    except Exception as exc:  # noqa: BLE001 - metadata pass is best-effort
        logger.warning("planner footer read failed (%s); planning from"
                       " defaults", exc)
        return {}


def _clamp(value: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(value)))


def plan_reader(info, read_fields: Sequence[str], *, policy, cores: int,
                cache_type: str = "null",
                cache_location: Optional[str] = None,
                transform_signature: str = "-",
                split_fields: Sequence[str] = (),
                workers_count="auto",
                decode_threads="auto",
                results_queue_size: int = 10,
                results_queue_pinned: bool = False,
                image_fields: Sequence[str] = ()) -> PlanVerdict:
    """Run the static pass over a declared pipeline; returns the
    :class:`PlanVerdict` ``make_reader(autotune=True)`` starts from.

    Knob resolution order per knob: an explicitly pinned user value wins
    (provenance ``pinned``, never overridden); else the recorded flight
    profile (``profile``), clamped into the policy's bounds; else the
    parquet-footer heuristics (``metadata``); else the static default.
    ``transform_signature`` is the precomputed
    :func:`petastorm_tpu_torch.transform.transform_cache_info` signature (the caller
    already ran the analysis walk once - it must not repeat here).
    """
    fp = dataset_fingerprint(info)
    sh = schema_hash(read_fields, transform_signature)
    store = ProfileStore(cache_location)
    profile = store.load(fp, sh)
    meta = footer_stats(info, read_fields)
    pk = (profile or {}).get("knobs", {})
    knobs: Dict[str, PlannedKnob] = {}

    def from_profile(name: str, lo: int, hi: int) -> Optional[PlannedKnob]:
        value = pk.get(name)
        if not isinstance(value, (int, float)):
            return None
        return PlannedKnob(_clamp(int(value), lo, hi), "profile",
                           f"recorded flight profile (converged at {value})")

    # -- workers ---------------------------------------------------------------
    static_default = max(1, min(10, cores - 1))
    if workers_count != "auto":
        knobs["workers"] = PlannedKnob(int(workers_count), "pinned",
                                       "explicit workers_count")
    else:
        planned = from_profile("workers", policy.min_workers,
                               policy.max_workers)
        if planned is None and meta:
            expansion = meta["expansion"]
            avg_unc = meta["avg_rowgroup_uncompressed_bytes"]
            if expansion >= 1.8 or image_fields:
                planned = PlannedKnob(
                    _clamp(static_default, policy.min_workers,
                           policy.max_workers),
                    "metadata",
                    f"decode-heavy columns (expansion {expansion:.1f}x):"
                    " every spare core decodes")
            elif expansion < 1.3 and avg_unc < 4 * 2 ** 20:
                planned = PlannedKnob(
                    _clamp(2, policy.min_workers, policy.max_workers),
                    "metadata",
                    f"lightweight columnar rowgroups ({avg_unc >> 10}KB"
                    f" decoded, expansion {expansion:.1f}x): IO-bound, a"
                    " narrow pool avoids handoff overhead")
        if planned is None:
            planned = PlannedKnob(
                _clamp(static_default, policy.min_workers,
                       policy.max_workers),
                "default", "cores - 1, capped at 10 (the static seed)")
        knobs["workers"] = planned

    workers = knobs["workers"].value

    # -- decode_threads --------------------------------------------------------
    if decode_threads != "auto":
        knobs["decode_threads"] = PlannedKnob(int(decode_threads), "pinned",
                                              "explicit decode_threads")
    else:
        knobs["decode_threads"] = PlannedKnob(
            max(1, cores // max(1, workers)), knobs["workers"].source
            if knobs["workers"].source != "pinned" else "default",
            "usable cores / planned workers (intra-batch decode fan-out)")

    # -- results queue bound ---------------------------------------------------
    if results_queue_pinned:
        knobs["results_queue"] = PlannedKnob(int(results_queue_size),
                                             "pinned",
                                             "explicit results_queue_size")
    else:
        planned = from_profile("results_queue", policy.min_results_queue,
                               policy.max_results_queue)
        if planned is None and meta \
                and meta["avg_rowgroup_uncompressed_bytes"] > 0:
            # bound decoded-batch RAM held in the results plane to ~64MB
            # while never starving the pool (at least workers + 2 slots)
            per_batch = meta["avg_rowgroup_uncompressed_bytes"]
            planned = PlannedKnob(
                _clamp(max(workers + 2, (64 * 2 ** 20) // per_batch),
                       policy.min_results_queue, policy.max_results_queue),
                "metadata",
                f"~64MB of decoded batches at {per_batch / 2 ** 20:.1f}MB"
                "/rowgroup, floored at workers + 2")
        if planned is None:
            planned = PlannedKnob(int(results_queue_size), "default",
                                  "static default bound")
        knobs["results_queue"] = planned

    # -- loader prefetch -------------------------------------------------------
    planned = from_profile("prefetch", policy.min_prefetch,
                           policy.max_prefetch)
    if planned is None and meta \
            and meta["avg_rowgroup_uncompressed_bytes"] > 0:
        small = meta["avg_rowgroup_uncompressed_bytes"] < 2 * 2 ** 20
        planned = PlannedKnob(
            _clamp(4 if small else 2, policy.min_prefetch,
                   policy.max_prefetch),
            "metadata",
            "small rowgroups: deeper prefetch smooths assembly jitter"
            if small else "large rowgroups: shallow prefetch bounds RAM")
    if planned is None:
        planned = PlannedKnob(2, "default", "static default depth")
    knobs["prefetch"] = planned

    # -- shared warm tier residency target ------------------------------------
    if cache_type == "shared":
        planned = from_profile("cache_mem", 16, 1 << 20)
        if planned is None and meta \
                and meta.get("est_dataset_uncompressed_bytes", 0) > 0:
            est_mb = int(1.2 * meta["est_dataset_uncompressed_bytes"]) >> 20
            planned = PlannedKnob(
                max(16, est_mb), "metadata",
                f"fits the estimated decoded dataset (~{est_mb}MB) so warm"
                " epochs never evict; clamped to the arena by the tier")
        if planned is not None:
            knobs["cache_mem"] = planned

    # -- live decode split -----------------------------------------------------
    if split_fields:
        value = pk.get("decode_split")
        if value in (0, 1):
            knobs["decode_split"] = PlannedKnob(
                int(value), "profile",
                "recorded flight profile (converged split side)")

    return PlanVerdict(knobs=knobs, fingerprint=fp, schema_hash=sh,
                       metadata=meta, profile=profile,
                       profile_path=store.path_for(fp, sh), store=store)


def build_profile(reader) -> Optional[dict]:
    """Payload for :meth:`ProfileStore.save`, from a finished reader: the
    autotune controller's CONVERGED knob values, the decision count, and the
    delivered rate observed over the sampler's trailing points.  None when
    the run has nothing worth recording (nothing consumed, or no
    controller)."""
    controller = getattr(reader, "autotune", None)
    if controller is None or getattr(reader, "_consumed_items", 0) <= 0:
        return None
    knobs = {name: int(value) for name, value in controller.knobs().items()}
    observed = None
    sampler = getattr(reader, "sampler", None)
    if sampler is not None:
        try:
            # flush the trailing partial interval: a short run may not have
            # completed a single full sampling interval yet
            sampler.sample_now()
        except Exception:  # noqa: BLE001 - the profile is best-effort
            pass
        points = sampler.series()[-10:]
        total_dt = sum(pt.get("dt_s", 0.0) for pt in points)
        if total_dt > 0:
            observed = round(sum(
                pt.get("rates", {}).get("reader.rows_emitted", 0.0)
                * pt.get("dt_s", 0.0) for pt in points) / total_dt, 2)
    import time as _time

    return {"written_at": _time.time(),
            "knobs": knobs,
            "observed_rows_per_sec": observed,
            "decisions": len(controller.decisions),
            "moves_kept": int(controller.diagnostics["moves_kept"]),
            "source": "autotune"}


def write_profile(reader) -> Optional[str]:
    """Persist this reader's flight profile (called once from
    ``Reader.stop``); returns the written path or None."""
    verdict = getattr(reader, "planner", None)
    if verdict is None or verdict.store is None:
        return None
    payload = build_profile(reader)
    if payload is None:
        return None
    path = verdict.store.save(verdict.fingerprint, verdict.schema_hash,
                              payload)
    if path:
        logger.info("pipeline flight profile written to %s (knobs %s)",
                    path, payload["knobs"])
    return path
