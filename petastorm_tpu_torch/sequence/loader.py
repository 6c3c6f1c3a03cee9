"""Device delivery of packed token streams through ``CudaDataLoader``.

Counterpart of ``petastorm_tpu/sequence/loader.py``.
:class:`PackedSequenceReader` wraps a token source (one
:func:`~petastorm_tpu_torch.sequence.dataset.make_sequence_reader` reader or
a :func:`~petastorm_tpu_torch.sequence.mixing.make_mixed_sequence_reader`
mixture) as a reader whose rows are PACKED sequences: four fixed-shape
``(seq_len,)`` columns, ``tokens``, ``segment_ids``, ``positions`` and
``loss_mask``.  Being ordinary numeric columns, they go through
``cuda.CudaDataLoader`` as any other: ``(batch, seq_len)`` tensors staged
in pinned memory and copied on the loader's copy stream, with its shuffle
buffer seeded from the source's seed root.
:func:`make_packed_sequence_loader` is the one-call path, corpora -> seeded
mixture -> packing -> tensors on the card (``petastorm_tpu/sequence/
loader.py:158`` builds a ``JaxDataLoader`` there).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from petastorm_tpu_torch.batch import ColumnBatch
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.sequence.dataset import iter_documents
from petastorm_tpu_torch.sequence.packing import SequencePacker, iter_packed_blocks
from petastorm_tpu_torch.telemetry import resolve as _resolve_telemetry


class PackedSequenceReader:
    """A token source packed into fixed-shape rows, behind the reader
    interface ``CudaDataLoader`` reads: ``schema`` and ``output_schema``
    (four ``(seq_len,)`` fields), ``iter_batches()`` (ColumnBatches of
    ``rows_per_batch`` packed rows), ``deterministic`` and ``shuffle_seed``
    passed through from the source (so the loader's buffer seeds derive from
    its seed root), no device-decode fields or declared geometries,
    ``diagnostics`` (the packer's ``stats()`` and the source's own) and
    ``stop()``/``join()``.  ``quiesce`` and ``state_dict`` raise: the
    packer's open bins are state a mid-stream cursor cannot express.
    """

    def __init__(self, source, seq_len: int, tokens_field: str = "tokens",
                 rows_per_batch: int = 64, open_bins: int = 8, long_docs: str = "split",
                 tokens_dtype=np.int32, mask_dtype=np.float32, pad_token: int = 0):
        if rows_per_batch < 1:
            raise PetastormTpuError("rows_per_batch must be >= 1")
        self._source = source
        self._tokens_field = tokens_field
        self._rows_per_batch = int(rows_per_batch)
        self._tokens_dtype = np.dtype(tokens_dtype)
        self.packer = SequencePacker(seq_len, open_bins=open_bins, long_docs=long_docs,
                                     tokens_dtype=tokens_dtype, mask_dtype=mask_dtype,
                                     pad_token=pad_token,
                                     telemetry=getattr(source, "telemetry", None))
        self.seq_len = int(seq_len)
        self.schema = Schema("PackedSequence", [
            Field("tokens", self._tokens_dtype, (self.seq_len,)),
            Field("segment_ids", np.int32, (self.seq_len,)),
            Field("positions", np.int32, (self.seq_len,)),
            Field("loss_mask", np.dtype(mask_dtype), (self.seq_len,)),
        ])
        self.output_schema = self.schema
        self.batched_output = True
        self.ngram = None
        self.deterministic = getattr(source, "deterministic", "off")
        self.shuffle_seed = getattr(source, "shuffle_seed", None)
        self.device_decode_fields: list = []
        self.device_decode_mixed: frozenset = frozenset()
        self.device_decode_split: frozenset = frozenset()
        self.declared_geometries: dict = {}
        self.last_row_consumed = False
        self._iterating = False

    @property
    def telemetry(self):
        """The source's recorder, where the packer's ``sequence.*`` series land."""
        return _resolve_telemetry(getattr(self._source, "telemetry", None))

    @property
    def diagnostics(self) -> Dict:
        """``{'packing': packer.stats(), 'source': <the source's diagnostics>}``
        (a mixture's carry its mixture digest)."""
        out: Dict = {"packing": self.packer.stats()}
        sub = getattr(self._source, "diagnostics", None)
        if isinstance(sub, dict):
            out["source"] = sub
        return out

    def iter_batches(self) -> Iterator[ColumnBatch]:
        """Packed rows as ColumnBatches of ``rows_per_batch`` rows (the last
        may be smaller).  One pass over the source, never two at once."""
        if self._iterating:
            raise PetastormTpuError(
                "PackedSequenceReader.iter_batches is single-pass; a second"
                " concurrent iteration would interleave packer state")
        self._iterating = True
        try:
            docs = iter_documents(self._source, self._tokens_field,
                                  tokens_dtype=self._tokens_dtype)
            for block in iter_packed_blocks(docs, self.seq_len, self._rows_per_batch,
                                            packer=self.packer):
                yield ColumnBatch(dict(block), len(block["tokens"]))
            self.last_row_consumed = True
        finally:
            self._iterating = False

    def stop(self) -> None:
        """Stop the wrapped source."""
        self._source.stop()

    def join(self) -> None:
        """Join the wrapped source (after ``stop()``)."""
        self._source.join()

    def quiesce(self):
        """Refused always: the packer's open bins cannot be expressed by a
        mid-stream cursor.  Checkpoint at epoch boundaries instead."""
        raise PetastormTpuError(
            "PackedSequenceReader does not support quiesce/state_dict: the"
            " packer holds open bins that a mid-stream cursor cannot"
            " express. Checkpoint at epoch boundaries (re-open the source"
            " with the next epoch's seed) instead.")

    #: the same refusal as :meth:`quiesce`
    state_dict = quiesce

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()


def make_packed_sequence_loader(dataset_urls, batch_size: int, seq_len: int,
                                weights: Optional[Sequence[float]] = None,
                                seed: Optional[int] = None, tokens_field: str = "tokens",
                                open_bins: int = 8, long_docs: str = "split",
                                tokens_dtype=np.int32, pad_token: int = 0,
                                device="cuda", loader_kwargs: Optional[dict] = None,
                                **reader_kwargs):
    """Corpora -> seeded mixture -> packing -> ``(batch_size, seq_len)``
    tensors on ``device`` (the card by default): a ``CudaDataLoader`` over a
    :class:`PackedSequenceReader`, whose batches are dicts of ``tokens``,
    ``segment_ids``, ``positions`` and ``loss_mask``.

    ``dataset_urls`` is one corpus URL or a sequence mixed by ``weights``;
    ``seed`` makes the corpus plans, the mixture draws and so the packing a
    pure function of it (``shuffle_seed`` is refused).  ``loader_kwargs``
    go to the loader, the other kwargs to every corpus reader.  A context
    manager: closing the loader closes the readers.

    Over a mesh (``loader_kwargs={"mesh": ..., "shardings": ...}``, one
    process a rank), ``batch_size`` is global and each rank's corpus readers
    read the shard of its block of the batch axis
    (``parallel.mesh.batch_block``, the rule of ``make_cuda_loader``), unless
    ``cur_shard`` is given: ranks that differ only on a ``seq`` dimension
    read, and pack, the same rows.  A rank's block of each batch is then its
    shard's packed rows in order.
    """
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.parallel.mesh import reader_shard
    from petastorm_tpu_torch.sequence.dataset import make_sequence_reader
    from petastorm_tpu_torch.sequence.mixing import make_mixed_sequence_reader

    mesh = (loader_kwargs or {}).get("mesh")
    if mesh is not None and "cur_shard" not in reader_kwargs:
        cur, count = reader_shard(mesh, loader_kwargs.get("shardings"))
        if count > 1:
            reader_kwargs = dict(reader_kwargs, cur_shard=cur, shard_count=count)
    if isinstance(dataset_urls, str):
        if "shuffle_seed" in reader_kwargs:
            raise PetastormTpuError(
                "pass seed= to make_packed_sequence_loader, not"
                " shuffle_seed= (one seed drives plans, mixing and packing)")
        source = make_sequence_reader(dataset_urls, tokens_field=tokens_field,
                                      shuffle_seed=seed, **reader_kwargs)
    else:
        source = make_mixed_sequence_reader(dataset_urls, weights=weights, seed=seed,
                                            tokens_field=tokens_field, **reader_kwargs)
    try:
        packed = PackedSequenceReader(source, seq_len, tokens_field=tokens_field,
                                      rows_per_batch=max(batch_size, 1), open_bins=open_bins,
                                      long_docs=long_docs, tokens_dtype=tokens_dtype,
                                      pad_token=pad_token)
        return CudaDataLoader(packed, batch_size=batch_size, device=device,
                              **(loader_kwargs or {}))
    except BaseException:
        source.stop()
        source.join()
        raise
