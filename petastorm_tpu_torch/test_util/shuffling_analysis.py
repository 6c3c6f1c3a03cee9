"""Shuffle quality: how far a read order is from the written order.

Counterpart of ``petastorm_tpu/test_util/shuffling_analysis.py``:
``rank_correlation`` (Spearman's rho of the read ids against their
positions; |rho| near 1 is barely shuffled, near 0 well decorrelated) and
``analyze_shuffle_quality``, whose loader arm is ``CudaDataLoader`` where the
JAX one uses ``JaxDataLoader`` (``:38``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rank_correlation(read_ids: np.ndarray) -> float:
    """Spearman rank correlation between read order and sequential id order."""
    read_ids = np.asarray(read_ids, dtype=np.float64)
    n = len(read_ids)
    if n < 2:
        return 1.0
    positions = np.arange(n, dtype=np.float64)
    rx = np.argsort(np.argsort(read_ids)).astype(np.float64)
    ry = np.argsort(np.argsort(positions)).astype(np.float64)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    return float((rx * ry).sum() / denom) if denom else 1.0


def analyze_shuffle_quality(dataset_url: str, id_field: str = "id",
                            shuffle_row_groups: bool = True,
                            shuffle_row_drop_partitions: int = 1,
                            shuffling_queue_capacity: int = 0,
                            seed: Optional[int] = 0, device="cuda") -> float:
    """Read the dataset and return the rank correlation of the observed
    order; with a ``shuffling_queue_capacity`` the rows go through
    ``CudaDataLoader``'s shuffle buffer onto ``device``."""
    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.reader import make_reader

    reader = make_reader(dataset_url, schema_fields=[id_field],
                         shuffle_row_groups=shuffle_row_groups,
                         shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                         shuffle_seed=seed, reader_pool_type="serial")
    ids = []
    if shuffling_queue_capacity:
        with CudaDataLoader(reader, batch_size=16, device=device, drop_last=False,
                            shuffling_queue_capacity=shuffling_queue_capacity,
                            buffer_seed=seed) as loader:
            for b in loader:
                n = int(b.get("_valid_rows", len(b[id_field])))
                ids.extend(b[id_field][:n].cpu().tolist())
    else:
        with reader:
            ids = [getattr(r, id_field) for r in reader]
    return rank_correlation(np.asarray(ids))
