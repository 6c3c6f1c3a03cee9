"""NGram: sliding-window readout of consecutive timesteps.

Counterpart of ``petastorm_tpu/ngram.py`` (the reference's petastorm/ngram.py):
``NGram(fields={offset: [fields]}, delta_threshold, timestamp_field,
timestamp_overlap, stack_timesteps)``.  Windows form within one rowgroup, over
rows sorted by ``timestamp_field`` (a stable sort), where every consecutive
timestamp delta inside the window is at most ``delta_threshold``.  With
``timestamp_overlap=False`` the windows are picked greedily left to right so
that none shares a row, before ``anchor_range`` keeps the starts of one
row-drop partition, so the partitions never pick overlapping windows.  The
gather is one fancy index a column.  ``stack_timesteps=True`` emits each field
read at every offset (fixed shape, non-object, non-nullable) as one
``(n_windows, length, ...)`` array; such a reader is columnar only.  Windows,
keys and key order equal the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.schema import Field, Schema

#: separator in flattened ngram column names: "<offset>/<field>"
NGRAM_KEY_SEP = "/"


class NGram:
    """Sliding-window spec: ``{offset: [fields]}`` read per window, windows
    anchored where consecutive ``timestamp_field`` values stay within
    ``delta_threshold``.  Pass to ``make_reader(ngram=...)``;
    ``stack_timesteps=True`` yields columnar (window, T, ...) arrays for the
    device-feed path instead of per-offset namedtuples."""

    def __init__(self,
                 fields: Dict[int, Sequence],
                 delta_threshold: Union[int, float],
                 timestamp_field: str,
                 timestamp_overlap: bool = True,
                 stack_timesteps: bool = False):
        if not fields:
            raise PetastormTpuError("NGram fields must be a non-empty {offset: [fields]}")
        offsets = sorted(fields)
        if offsets != list(range(offsets[0], offsets[0] + len(offsets))):
            raise PetastormTpuError(f"NGram offsets must be consecutive, got {offsets}")
        self._fields = {k: list(v) for k, v in fields.items()}
        self._offsets = offsets
        self.length = len(offsets)
        self.delta_threshold = delta_threshold
        if hasattr(timestamp_field, "name"):  # accept a Field (reference accepts both)
            timestamp_field = timestamp_field.name
        self.timestamp_field = timestamp_field
        self.timestamp_overlap = timestamp_overlap
        self.stack_timesteps = stack_timesteps

    @property
    def offsets(self) -> List[int]:
        """Sorted timestep offsets this window spec covers."""
        return list(self._offsets)

    def __eq__(self, other):
        if not isinstance(other, NGram):
            return NotImplemented
        return (self._fields == other._fields
                and self.delta_threshold == other.delta_threshold
                and self.timestamp_field == other.timestamp_field
                and self.timestamp_overlap == other.timestamp_overlap
                and self.stack_timesteps == other.stack_timesteps)

    def __hash__(self):
        return hash((tuple(sorted((k, tuple(v)) for k, v in self._fields.items())),
                     self.delta_threshold, self.timestamp_field,
                     self.timestamp_overlap, self.stack_timesteps))

    def resolve_schema(self, schema: Schema) -> Dict[int, Schema]:
        """Per-offset schema views with regex/Field resolution (ngram.py:303-326)."""
        out = {}
        for off in self._offsets:
            out[off] = schema.view(self._fields[off])
        return out

    def required_fields(self, schema: Schema) -> List[str]:
        """Union of all per-offset fields plus the timestamp field."""
        names: List[str] = []
        for off in self._offsets:
            for n in schema.resolve_fields(self._fields[off]):
                if n not in names:
                    names.append(n)
        if self.timestamp_field not in names:
            names.append(self.timestamp_field)
        return names

    @staticmethod
    def _stackable(field) -> bool:
        """Static test for whether a field's decoded columns can stack into one
        (n, k, ...) array.  Must be decidable from the schema alone so
        ``output_schema`` and ``form_windows`` always agree: fixed shape,
        non-object dtype, and non-nullable (a null cell turns the decoded
        column into an object array at runtime)."""
        return (field.is_fixed_shape and field.dtype != np.dtype(object)
                and not field.nullable)

    # -- window formation -----------------------------------------------------

    def window_starts(self, timestamps: np.ndarray,
                      anchor_range: Optional[tuple] = None) -> np.ndarray:
        """Valid window start indices over timestamp-sorted rows.

        A window of ``length`` rows starting at i is valid iff every consecutive
        timestamp delta within it is <= delta_threshold (ngram.py:179-193).
        ``anchor_range=(lo, hi)`` keeps only starts in [lo, hi) - used for
        row-drop partitions (reference lookahead borrowing,
        py_dict_reader_worker.py:254-274).  With ``timestamp_overlap=False``,
        selected windows share no rows (greedy left-to-right, ngram.py:225-270).
        """
        n = len(timestamps)
        k = self.length
        if n < k:
            return np.empty(0, dtype=np.int64)
        deltas = np.diff(np.asarray(timestamps))
        if np.any(deltas < 0):
            raise PetastormTpuError(
                f"NGram requires rows sorted by {self.timestamp_field!r}")
        ok = deltas <= self.delta_threshold
        if k == 1:
            starts = np.arange(n, dtype=np.int64)
        else:
            # all k-1 consecutive deltas inside the window must be ok
            win_ok = np.lib.stride_tricks.sliding_window_view(ok, k - 1).all(axis=1)
            starts = np.nonzero(win_ok)[0].astype(np.int64)
        if not self.timestamp_overlap and len(starts):
            # greedy dedup BEFORE anchor filtering, so the selected set is a
            # global property of the rows and row-drop partitions (which each
            # see a different anchor range) never pick overlapping windows
            keep = []
            next_free = -1
            for s in starts:
                if s >= next_free:
                    keep.append(s)
                    next_free = s + k
            starts = np.asarray(keep, dtype=np.int64)
        if anchor_range is not None:
            lo, hi = anchor_range
            starts = starts[(starts >= lo) & (starts < hi)]
        return starts

    def form_windows(self, schema: Schema, batch: ColumnBatch,
                     anchor_range: Optional[tuple] = None) -> ColumnBatch:
        """Sorted batch -> flattened ngram ColumnBatch ('<offset>/<field>' keys);
        with ``stack_timesteps`` a field read at every offset becomes one
        ``(n_windows, length, ...)`` column under its own name."""
        ts = batch.columns[self.timestamp_field]
        order = np.argsort(np.asarray(ts), kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            batch = ColumnBatch({n: c[order] for n, c in batch.columns.items()},
                                batch.num_rows)
            ts = batch.columns[self.timestamp_field]
        starts = self.window_starts(ts, anchor_range)
        base = self._offsets[0]
        out: Dict[str, np.ndarray] = {}
        per_offset_fields = {off: schema.resolve_fields(self._fields[off])
                             for off in self._offsets}
        for off in self._offsets:
            idx = starts + (off - base)
            for name in per_offset_fields[off]:
                out[f"{off}{NGRAM_KEY_SEP}{name}"] = batch.columns[name][idx]
        if self.stack_timesteps:
            # fields present at EVERY offset collapse to one (n, k, ...) array.
            # The stackability test is the schema-static one, so the emitted
            # columns always match ``output_schema``.
            common = [n for n in per_offset_fields[self._offsets[0]]
                      if all(n in per_offset_fields[o] for o in self._offsets)
                      and self._stackable(schema[n])]
            for name in common:
                parts = [out.pop(f"{o}{NGRAM_KEY_SEP}{name}") for o in self._offsets]
                out[name] = np.stack(parts, axis=1)
        return ColumnBatch(out, len(starts))

    def output_schema(self, schema: Schema) -> Schema:
        """Schema of the columnar batches ``form_windows`` emits.

        Non-stacked: one ``'<offset>/<field>'`` entry per (offset, field).
        Stacked: fields present at every offset become ``(length,) + shape``
        entries under their plain name (only when statically stackable: fixed
        shape, non-object dtype - mirroring the runtime check in
        ``form_windows``); the rest keep flat keys.
        """
        per_offset = {off: schema.resolve_fields(self._fields[off])
                      for off in self._offsets}
        out = []
        stacked = set()
        if self.stack_timesteps:
            for name in per_offset[self._offsets[0]]:
                f = schema[name]
                if (all(name in per_offset[o] for o in self._offsets)
                        and self._stackable(f)):
                    out.append(Field(name, f.dtype, (self.length,) + f.shape,
                                     nullable=f.nullable))
                    stacked.add(name)
        for off in self._offsets:
            for name in per_offset[off]:
                if name in stacked:
                    continue
                f = schema[name]
                out.append(Field(f"{off}{NGRAM_KEY_SEP}{name}", f.dtype,
                                 f.shape, f.codec, f.nullable))
        return Schema(f"{schema.name}_ngram", out)

    def make_namedtuple_types(self, schema: Schema):
        """offset -> namedtuple type of a window's rows (what row iteration
        yields for each timestep)."""
        views = self.resolve_schema(schema)
        return {off: view.make_namedtuple_type() for off, view in views.items()}

    def row(self, views, types, ngram_batch: ColumnBatch, i: int) -> Dict:
        """One window as {offset: namedtuple} (reference row-path shape)."""
        out = {}
        for off, view in views.items():
            vals = {f.name: ngram_batch.columns[f"{off}{NGRAM_KEY_SEP}{f.name}"][i]
                    for f in view}
            out[off] = types[off](**vals)
        return out
