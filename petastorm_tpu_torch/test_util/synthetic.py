"""Synthetic data for the port's checks and tests.

A trimmed copy of ``petastorm_tpu/test_util/synthetic.py`` over the port's
writer and schema: ``synthetic_rgb_image`` (a smooth RGB frame that
compresses like a photo), ``write_token_corpus`` (lognormal document
lengths) and ``write_wide_dataset`` (an id column and float32 vector
columns: the shape where a read a column chunk would hurt on a remote
store).  The rest of the JAX module (``TEST_SCHEMA``, ``random_row``,
``create_test_dataset``, ``synthetic_jpeg_bytes``) waits for ROADMAP.md
queue A item 12.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.schema import Field, Schema


def synthetic_rgb_image(i: int, height: int, width: int,
                        noise: float = 6.0,
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A deterministic smooth RGB test image (it compresses like a photo, not
    like random noise); ``noise`` adds seeded Gaussian noise."""
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    base = (np.stack([np.sin(x / (7.0 + i % 5)), np.cos(y / 6.0),
                      np.sin((x + y) / 11.0)], -1) + 1) * 110
    if noise:
        base = base + (rng or np.random.default_rng(i)).normal(0, noise,
                                                               base.shape)
    return base.clip(0, 255).astype(np.uint8)


def write_token_corpus(url: str, n_docs: int = 400,
                       rows_per_rg: int = 32, vocab: int = 32000,
                       mean_len: float = 48.0, min_len: int = 1,
                       max_len: int = 512, seed: int = 0,
                       label_field: Optional[str] = "lang",
                       tokens_dtype=None, **write_kwargs) -> int:
    """A north-star-shaped token corpus: ``doc_id`` + ``n_tokens`` scalars,
    a ``tokens`` variable-length int32 column (lognormal document lengths -
    the long-tail shape real corpora have), and an optional small-cardinality
    ``label_field`` for predicate tests.  Returns the total token count."""
    from petastorm_tpu_torch.sequence.dataset import token_field

    tokens_dtype = np.dtype(tokens_dtype or np.int32)
    fields = [Field("doc_id", np.int64), Field("n_tokens", np.int32),
              token_field("tokens", dtype=tokens_dtype)]
    if label_field:
        fields.append(Field(label_field, np.dtype("object")))
    schema = Schema("TokenCorpus", fields)
    rng = np.random.default_rng(seed)
    sigma = 0.75
    lengths = np.clip(rng.lognormal(np.log(mean_len) - sigma ** 2 / 2,
                                    sigma, n_docs),
                      min_len, max_len).astype(np.int64)
    rows = []
    total = 0
    for i in range(n_docs):
        n = int(lengths[i])
        total += n
        row = {"doc_id": i, "n_tokens": n,
               "tokens": rng.integers(0, vocab, n, dtype=tokens_dtype)}
        if label_field:
            row[label_field] = f"l{int(rng.integers(0, 4))}"
        rows.append(row)
    write_dataset(url, schema, rows, row_group_size_rows=rows_per_rg,
                  **write_kwargs)
    return total


def write_wide_dataset(url: str, n_cols: int = 8, n_rowgroups: int = 8,
                       rows_per_rg: int = 32, vec_len: int = 16,
                       seed: int = 0) -> None:
    """A many-column 'wide' parquet dataset: an ``id`` int64 column plus
    ``n_cols - 1`` float32 vector columns - the shape where per-column-chunk
    remote reads would hurt most."""
    schema = Schema("Wide", [Field("id", np.int64)] + [
        Field(f"c{i}", np.float32, (vec_len,)) for i in range(n_cols - 1)])
    rng = np.random.default_rng(seed)
    rows = [dict({"id": i},
                 **{f"c{c}": rng.standard_normal(vec_len).astype(np.float32)
                    for c in range(n_cols - 1)})
            for i in range(n_rowgroups * rows_per_rg)]
    write_dataset(url, schema, rows, row_group_size_rows=rows_per_rg)
