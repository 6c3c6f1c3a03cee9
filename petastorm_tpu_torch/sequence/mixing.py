"""Deterministic mixing of several token corpora by weight.

Counterpart of ``petastorm_tpu/sequence/mixing.py``.  One seed drives the
whole mixture: corpus ``i`` reads seed-stable with ``shuffle_seed =
corpus_seed(seed, i)`` (``seeding.derive_seed(seed, 0, 'sequence.corpus',
i)``), so no two corpora share a permutation stream, and the mixer draws
from ``derive_seed(seed, 0, 'sequence.mixture')``.  The draws fold into the
mixer's ``mixture_digest`` (``weighted_sampling.WeightedSamplingReader``),
so two mixed runs compare by one value.
"""

from __future__ import annotations

from typing import Optional, Sequence

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.seeding import derive_seed
from petastorm_tpu_torch.sequence.dataset import make_sequence_reader
from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader


def corpus_seed(seed: Optional[int], corpus_index: int) -> Optional[int]:
    """The shuffle seed of corpus ``corpus_index`` under mixture seed
    ``seed`` (None stays None: unseeded corpora keep unseeded plans)."""
    if seed is None:
        return None
    return derive_seed(seed, 0, "sequence.corpus", corpus_index)


def make_mixed_sequence_reader(dataset_urls: Sequence[str],
                               weights: Optional[Sequence[float]] = None,
                               seed: Optional[int] = None, tokens_field: str = "tokens",
                               **reader_kwargs) -> WeightedSamplingReader:
    """Open N token corpora with :func:`make_sequence_reader` and mix them by
    ``weights`` (uniform by default) in a ``WeightedSamplingReader``; the
    mixed document stream is a pure function of ``(seed, weights,
    corpora)``, and ``seed=None`` leaves every stage unseeded.  The other
    kwargs go to every corpus reader; ``shuffle_seed`` is refused, since the
    per-corpus seeds derive from ``seed``."""
    if not dataset_urls:
        raise PetastormTpuError("dataset_urls must name at least one corpus")
    if "shuffle_seed" in reader_kwargs:
        raise PetastormTpuError(
            "pass seed= to make_mixed_sequence_reader, not shuffle_seed=:"
            " per-corpus seeds are derived from the one mixture seed"
            " (corpora must not share a permutation stream)")
    if weights is None:
        weights = [1.0] * len(dataset_urls)
    if len(weights) != len(dataset_urls):
        raise PetastormTpuError(f"{len(dataset_urls)} corpora but {len(weights)} weights")
    readers = []
    try:
        for i, url in enumerate(dataset_urls):
            readers.append(make_sequence_reader(url, tokens_field=tokens_field,
                                                shuffle_seed=corpus_seed(seed, i),
                                                **reader_kwargs))
        mixer_seed = derive_seed(seed, 0, "sequence.mixture") if seed is not None else None
        return WeightedSamplingReader(readers, weights, seed=mixer_seed)
    except BaseException:
        for r in readers:
            r.stop()
        for r in readers:
            r.join()
        raise
