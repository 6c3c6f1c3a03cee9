"""Token corpora as a reader workload: the document column and its reader.

Counterpart of ``petastorm_tpu/sequence/dataset.py``.  A token corpus is an
ordinary dataset whose document column is a variable-length 1-D list field
(:func:`token_field`: arrow ``list<int>`` storage through
``codecs.ScalarListCodec``, so plain-Parquet tools read it too).
:func:`make_sequence_reader` is ``make_batch_reader`` checked for that
column; :func:`iter_documents` flattens its batches into one document at a
time, the stream the packer (``sequence.packing``) consumes.  Predicates
push down as for images: the predicate columns decode first and only the
surviving rows' token lists decode, and with telemetry the worker counts
the rows the predicate dropped as ``sequence.rows_filtered``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from petastorm_tpu_torch.codecs import ScalarListCodec
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.schema import Field


def token_field(name: str = "tokens", dtype=np.int32, nullable: bool = False) -> Field:
    """A variable-length token-sequence field: 1-D ``dtype`` tokens stored as
    an arrow list column (``ScalarListCodec``)."""
    return Field(name, np.dtype(dtype), shape=(None,), codec=ScalarListCodec(),
                 nullable=nullable)


def is_sequence_field(field: Field) -> bool:
    """True for a variable-length 1-D column: one declared with
    :func:`token_field` or an inferred plain-Parquet list column."""
    return (isinstance(field.codec, ScalarListCodec)
            or (len(field.shape) == 1 and field.shape[0] is None))


def make_sequence_reader(dataset_url, tokens_field: str = "tokens", **reader_kwargs):
    """``make_batch_reader`` over a token corpus, refusing a ``tokens_field``
    that is missing or is not a variable-length sequence column (a typo, a
    fixed-shape column, an image) at construction rather than as a packer
    error mid-epoch.  Every ``make_batch_reader`` argument passes through."""
    from petastorm_tpu_torch.reader import make_batch_reader

    reader = make_batch_reader(dataset_url, **reader_kwargs)
    try:
        schema = reader.schema
        if tokens_field not in schema:
            raise PetastormTpuError(
                f"tokens_field {tokens_field!r} is not in the dataset schema"
                f" {[f.name for f in schema]} (or was excluded by schema_fields)")
        field = schema[tokens_field]
        if not is_sequence_field(field):
            raise PetastormTpuError(
                f"tokens_field {tokens_field!r} is not a variable-length sequence column"
                f" (shape {field.shape}, codec {field.codec!r}); declare it with"
                " petastorm_tpu_torch.sequence.token_field(...) or point tokens_field at"
                " the list column")
    except BaseException:
        reader.stop()
        reader.join()
        raise
    return reader


def iter_documents(reader, tokens_field: str = "tokens", tokens_dtype=np.int32,
                   max_documents: Optional[int] = None) -> Iterator[np.ndarray]:
    """The reader's batches flattened to one 1-D ``tokens_dtype`` document at
    a time, in delivered order.  Takes both wire forms of a list column: the
    2-D array of a rowgroup whose lists share one length, and the object
    array of ragged or nullable ones.  ``None`` cells are skipped; empty
    lists are yielded (the packer skips them).  ``max_documents`` bounds the
    iteration and leaves the reader running."""
    tokens_dtype = np.dtype(tokens_dtype)
    n = 0
    for batch in reader.iter_batches():
        col = batch.columns[tokens_field]
        if col.dtype != object:
            docs = np.asarray(col).astype(tokens_dtype, copy=False)
        else:
            docs = (np.asarray(cell).ravel().astype(tokens_dtype, copy=False)
                    for cell in col if cell is not None)
        for doc in docs:
            yield doc
            n += 1
            if max_documents is not None and n >= max_documents:
                return
