"""The token feed: tokenized-text corpora, deterministic sequence packing,
ragged delivery and seeded mixing of corpora, delivered to the card.

Counterpart of ``petastorm_tpu/sequence/``, with the same ``__all__``:

* :mod:`~petastorm_tpu_torch.sequence.dataset`: token corpora as
  variable-length list columns, checked readers, the document stream;
* :mod:`~petastorm_tpu_torch.sequence.packing`: first-fit-shrinking packing
  into ``(batch, seq_len)`` blocks with segment ids, positions and loss
  masks, ragged delivery and the packed-stream digest;
* :mod:`~petastorm_tpu_torch.sequence.mixing`: N corpora mixed by weight,
  the whole mixture a pure function of one seed;
* :mod:`~petastorm_tpu_torch.sequence.loader`: ``CudaDataLoader`` delivery
  of ``(tokens, segment_ids, positions, loss_mask)`` tensors.
"""

from petastorm_tpu_torch.sequence.dataset import (is_sequence_field, iter_documents,
                                                  make_sequence_reader, token_field)
from petastorm_tpu_torch.sequence.loader import (PackedSequenceReader,
                                                 make_packed_sequence_loader)
from petastorm_tpu_torch.sequence.mixing import corpus_seed, make_mixed_sequence_reader
from petastorm_tpu_torch.sequence.packing import (PACKED_FIELDS, SequencePacker,
                                                  iter_packed_blocks, iter_packed_rows,
                                                  iter_ragged_batches, packed_stream_digest)

__all__ = [
    "token_field", "is_sequence_field", "make_sequence_reader",
    "iter_documents",
    "SequencePacker", "iter_packed_rows", "iter_packed_blocks",
    "iter_ragged_batches", "packed_stream_digest", "PACKED_FIELDS",
    "make_mixed_sequence_reader", "corpus_seed",
    "PackedSequenceReader", "make_packed_sequence_loader",
]
