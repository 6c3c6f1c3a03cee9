"""Deterministic sequence packing: variable-length documents -> fixed
``(batch, seq_len)`` token blocks.

Counterpart of ``petastorm_tpu/sequence/packing.py``, equal to it block for
block and digest for digest.  :class:`SequencePacker` is a streaming
first-fit-shrinking bin packer: a pure function of the document order (no
clock, no RNG), so under seed-stable reader delivery the packed stream is
the same whatever the worker count.  Each packed row carries
``segment_ids`` (1-based a document, 0 on padding), ``positions``
(restarting at 0 a document) and a ``loss_mask`` (1 on real tokens), the
quadruple a packed-attention step consumes.  :func:`iter_ragged_batches`
is the other delivery: a flat token buffer plus offsets, for consumers
that pack on the device.  :func:`packed_stream_digest` is the stream's
certificate.  The JAX packer's ``telemetry=`` argument and its
``sequence.*`` series are not part of this package yet (ROADMAP.md queue A
item 11); ``stats()`` and ``fill_rate`` carry the same numbers.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError

#: policies for a document longer than ``seq_len``
LONG_DOC_POLICIES = ("split", "truncate", "error")

#: field order of the packed-stream digest (fixed, so the digest never
#: depends on dict ordering)
PACKED_FIELDS = ("tokens", "segment_ids", "positions", "loss_mask")


class _Bin:
    """One open bin: a preallocated output row being filled."""

    __slots__ = ("tokens", "segment_ids", "positions", "loss_mask", "used", "segments")

    def __init__(self, seq_len: int, tokens_dtype, mask_dtype, pad_token):
        self.tokens = np.full(seq_len, pad_token, dtype=tokens_dtype)
        self.segment_ids = np.zeros(seq_len, dtype=np.int32)
        self.positions = np.zeros(seq_len, dtype=np.int32)
        self.loss_mask = np.zeros(seq_len, dtype=mask_dtype)
        self.used = 0
        self.segments = 0

    def place(self, doc: np.ndarray) -> None:
        n = len(doc)
        lo, hi = self.used, self.used + n
        self.tokens[lo:hi] = doc
        self.segments += 1
        self.segment_ids[lo:hi] = self.segments
        self.positions[lo:hi] = np.arange(n, dtype=np.int32)
        self.loss_mask[lo:hi] = 1
        self.used = hi

    def row(self) -> Dict[str, np.ndarray]:
        return {"tokens": self.tokens, "segment_ids": self.segment_ids,
                "positions": self.positions, "loss_mask": self.loss_mask}


class SequencePacker:
    """Streaming first-fit-shrinking bin packer over a document stream.

    Feed 1-D token arrays in stream order; completed rows come back as
    ``{'tokens', 'segment_ids', 'positions', 'loss_mask'}`` dicts of
    ``(seq_len,)`` arrays.  The algorithm, exactly (``packing.py:81-93`` of
    the JAX package):

    * up to ``open_bins`` partly filled bins are kept, in creation order;
    * a document goes to the FIRST open bin it fits; a bin that fills
      exactly is emitted at once;
    * when nothing fits and the open set is full, the bin with the LEAST
      room left (the oldest on ties) is emitted, and a fresh bin takes the
      document;
    * ``finish()`` emits the remaining bins in creation order.

    A document longer than ``seq_len`` follows ``long_docs``: ``'split'``
    (chunks of ``seq_len``, each its own segment), ``'truncate'`` (its first
    ``seq_len`` tokens) or ``'error'``.  Empty and None documents are
    skipped and counted.
    """

    def __init__(self, seq_len: int, open_bins: int = 8, long_docs: str = "split",
                 tokens_dtype=np.int32, mask_dtype=np.float32, pad_token: int = 0):
        if seq_len < 1:
            raise PetastormTpuError("seq_len must be >= 1")
        if open_bins < 1:
            raise PetastormTpuError("open_bins must be >= 1")
        if long_docs not in LONG_DOC_POLICIES:
            raise PetastormTpuError(
                f"long_docs must be one of {LONG_DOC_POLICIES}; got {long_docs!r}")
        self.seq_len = int(seq_len)
        self._open_limit = int(open_bins)
        self._long_docs = long_docs
        self._tokens_dtype = np.dtype(tokens_dtype)
        self._mask_dtype = np.dtype(mask_dtype)
        self._pad_token = pad_token
        self._bins: List[_Bin] = []
        self._finished = False
        self._docs = 0
        self._docs_split = 0
        self._docs_truncated = 0
        self._docs_empty = 0
        self._tokens = 0
        self._rows = 0

    def _emit(self, idx: int) -> Dict[str, np.ndarray]:
        self._rows += 1
        return self._bins.pop(idx).row()

    def _chunks(self, doc: np.ndarray) -> List[np.ndarray]:
        """The pieces ``doc`` packs as, under the long-document policy; counts
        the document and the tokens it keeps."""
        self._docs += 1
        if len(doc) <= self.seq_len:
            chunks = [doc]
        elif self._long_docs == "split":
            self._docs_split += 1
            chunks = [doc[i:i + self.seq_len] for i in range(0, len(doc), self.seq_len)]
        elif self._long_docs == "truncate":
            self._docs_truncated += 1
            chunks = [doc[:self.seq_len]]
        else:
            raise PetastormTpuError(
                f"document of {len(doc)} tokens exceeds seq_len {self.seq_len}"
                " (long_docs='error')")
        self._tokens += sum(len(c) for c in chunks)
        return chunks

    def feed(self, doc) -> List[Dict[str, np.ndarray]]:
        """Pack one document; returns the rows it completed (usually none or
        one, more when a long document splits)."""
        if self._finished:
            raise PetastormTpuError("SequencePacker.feed after finish()")
        if doc is None:
            self._docs_empty += 1
            return []
        doc = np.asarray(doc)
        if doc.ndim != 1:
            raise PetastormTpuError(f"documents must be 1-D token arrays; got shape {doc.shape}")
        if len(doc) == 0:
            self._docs_empty += 1
            return []
        out: List[Dict[str, np.ndarray]] = []
        for chunk in self._chunks(doc):
            n = len(chunk)
            fit = next((i for i, b in enumerate(self._bins) if self.seq_len - b.used >= n), None)
            if fit is None:
                if len(self._bins) >= self._open_limit:
                    # the most-shrunk bin ships (least room left; oldest on ties)
                    out.append(self._emit(min(range(len(self._bins)),
                                              key=lambda i: self.seq_len - self._bins[i].used)))
                self._bins.append(_Bin(self.seq_len, self._tokens_dtype, self._mask_dtype,
                                       self._pad_token))
                fit = len(self._bins) - 1
            self._bins[fit].place(chunk)
            if self._bins[fit].used == self.seq_len:
                out.append(self._emit(fit))
        return out

    def finish(self) -> List[Dict[str, np.ndarray]]:
        """Close and emit the remaining open bins, in creation order."""
        self._finished = True
        out = []
        while self._bins:
            out.append(self._emit(0))
        return out

    @property
    def fill_rate(self) -> float:
        """Real tokens over emitted slots (0.0 before the first row); the
        tokens of bins still open are left out until they emit."""
        slots = self._rows * self.seq_len
        if not slots:
            return 0.0
        return (self._tokens - sum(b.used for b in self._bins)) / slots

    def stats(self) -> Dict:
        """Documents, splits, truncations, empties, tokens, rows, fill rate."""
        return {"docs": self._docs,
                "docs_split": self._docs_split,
                "docs_truncated": self._docs_truncated,
                "docs_empty": self._docs_empty,
                "tokens": self._tokens,
                "rows": self._rows,
                "seq_len": self.seq_len,
                "fill_rate": round(self.fill_rate, 4)}


def iter_packed_rows(docs: Iterable, seq_len: int, packer: Optional[SequencePacker] = None,
                     finish: bool = True, **packer_kwargs) -> Iterator[Dict[str, np.ndarray]]:
    """Pack a document iterable; yields completed rows in emission order.

    Pass a ``packer`` to read its accounting afterwards, and ``finish=False``
    on all but the last call to keep packing with it.  A given packer must
    agree with ``seq_len`` and takes no ``packer_kwargs``."""
    if packer is not None:
        if packer.seq_len != seq_len:
            raise PetastormTpuError(
                f"packer.seq_len {packer.seq_len} != seq_len {seq_len}:"
                " the packer's width wins silently otherwise")
        if packer_kwargs:
            raise PetastormTpuError(
                f"packer_kwargs {sorted(packer_kwargs)} are ignored when an"
                " existing packer is passed; configure the packer instead")
    p = packer if packer is not None else SequencePacker(seq_len, **packer_kwargs)
    for doc in docs:
        yield from p.feed(doc)
    if finish:
        yield from p.finish()


def iter_packed_blocks(docs: Iterable, seq_len: int, batch_size: int,
                       packer: Optional[SequencePacker] = None, drop_last: bool = False,
                       **packer_kwargs) -> Iterator[Dict[str, np.ndarray]]:
    """Pack documents into dense ``(batch_size, seq_len)`` blocks of the four
    :data:`PACKED_FIELDS`; the last block may be shorter (``drop_last``
    drops it)."""
    if batch_size < 1:
        raise PetastormTpuError("batch_size must be >= 1")
    pending: List[Dict[str, np.ndarray]] = []
    for row in iter_packed_rows(docs, seq_len, packer=packer, **packer_kwargs):
        pending.append(row)
        if len(pending) == batch_size:
            yield {k: np.stack([r[k] for r in pending]) for k in pending[0]}
            pending = []
    if pending and not drop_last:
        yield {k: np.stack([r[k] for r in pending]) for k in pending[0]}


def iter_ragged_batches(docs: Iterable, batch_docs: int,
                        tokens_dtype=np.int32) -> Iterator[Dict[str, np.ndarray]]:
    """Groups of ``batch_docs`` documents as ``{'tokens': (total,), 'offsets':
    (n + 1,) int64, 'lengths': (n,) int32}``: document ``i`` is
    ``tokens[offsets[i]:offsets[i + 1]]``.  The last group may be smaller;
    empty and None documents stay as zero-length spans."""
    if batch_docs < 1:
        raise PetastormTpuError("batch_docs must be >= 1")
    tokens_dtype = np.dtype(tokens_dtype)
    group: List[np.ndarray] = []

    def _flush():
        lengths = np.asarray([len(d) for d in group], dtype=np.int32)
        offsets = np.zeros(len(group) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = (np.concatenate(group).astype(tokens_dtype, copy=False)
                if offsets[-1] else np.empty(0, dtype=tokens_dtype))
        return {"tokens": flat, "offsets": offsets, "lengths": lengths}

    for doc in docs:
        group.append(np.empty(0, dtype=tokens_dtype) if doc is None
                     else np.asarray(doc).ravel())
        if len(group) == batch_docs:
            yield _flush()
            group = []
    if group:
        yield _flush()


def packed_stream_digest(blocks: Iterable[Dict[str, np.ndarray]], crc: int = 0) -> int:
    """Order-sensitive crc32 chain over a packed block stream: each block's
    ``(rows, seq_len)`` as two little-endian int64, then the bytes of the
    four :data:`PACKED_FIELDS` in that order.  Pass the previous value as
    ``crc`` to chain across calls."""
    for block in blocks:
        rows, seq_len = np.asarray(block["tokens"]).shape
        crc = zlib.crc32(struct.pack("<2q", rows, seq_len), crc)
        for name in PACKED_FIELDS:
            crc = zlib.crc32(np.ascontiguousarray(np.asarray(block[name])).tobytes(), crc)
    return crc
