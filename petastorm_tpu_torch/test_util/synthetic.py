"""Synthetic data for the port's checks and tests.

Counterpart of ``petastorm_tpu/test_util/synthetic.py`` over the port's
writer and schema: ``TEST_SCHEMA`` (every codec, dtype, nullable and
variable-shape case) with ``random_row`` and ``create_test_dataset``;
``synthetic_rgb_image`` (a smooth RGB frame that compresses like a photo)
and ``synthetic_jpeg_bytes``; ``write_token_corpus`` (lognormal document
lengths) and ``write_wide_dataset`` (an id column and float32 vector
columns: the shape where a read a column chunk would hurt on a remote
store).  Each draws from a seeded numpy generator in the JAX module's order,
so both packages write the same rows from one seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec)
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.schema import Field, Schema

TEST_SCHEMA = Schema("TestSchema", [
    Field("id", np.int64),
    Field("id2", np.int32),
    Field("partition_key", np.dtype("object")),
    Field("python_primitive_uint8", np.uint8),
    Field("image_png", np.uint8, (16, 12, 3), CompressedImageCodec("png")),
    Field("matrix", np.float32, (4, 5), NdarrayCodec()),
    Field("matrix_compressed", np.float32, (4, 5), CompressedNdarrayCodec()),
    Field("matrix_var", np.float64, (None, 2), NdarrayCodec()),
    Field("sensor_name", np.dtype("object")),
    Field("timestamp_s", np.int64),
    Field("nullable_float", np.float64, nullable=True),
])


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


def synthetic_jpeg_bytes(n: int, height: int, width: int,
                         quality: int = 90) -> List[bytes]:
    """``n`` same-geometry JPEG streams of ``synthetic_rgb_image`` frames."""
    import cv2

    out = []
    for i in range(n):
        ok, enc = cv2.imencode(
            ".jpeg", cv2.cvtColor(synthetic_rgb_image(i, height, width), cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        out.append(enc.tobytes())
    return out


def random_row(schema: Schema, rng: np.random.Generator, row_index: int) -> Dict:
    """One schema-conformant random row (reference: generator.py:21-47)."""
    row: Dict = {}
    for f in schema:
        if f.name == "id":
            row[f.name] = row_index
            continue
        if f.name == "timestamp_s":
            row[f.name] = 1_000_000 + row_index
            continue
        if f.nullable and rng.random() < 0.3:
            row[f.name] = None
            continue
        if f.shape == ():
            if f.dtype.kind == "O":
                row[f.name] = f"{f.name}_{rng.integers(0, 5)}"
            elif f.dtype.kind in "ui":
                row[f.name] = int(rng.integers(0, np.iinfo(f.dtype).max // 2, dtype=f.dtype))
            elif f.dtype.kind == "f":
                row[f.name] = float(rng.random())
            elif f.dtype.kind == "b":
                row[f.name] = bool(rng.integers(0, 2))
            else:
                raise ValueError(f"no generator for {f}")
        else:
            shape = tuple(d if d is not None else int(rng.integers(1, 6)) for d in f.shape)
            if f.dtype.kind in "ui":
                row[f.name] = rng.integers(0, 255, shape).astype(f.dtype)
            else:
                row[f.name] = rng.standard_normal(shape).astype(f.dtype)
    return row


def create_test_dataset(url: str, num_rows: int = 100, row_group_size_rows: int = 10,
                        schema: Optional[Schema] = None, seed: int = 1234,
                        **write_kwargs) -> List[Dict]:
    """Write a synthetic dataset of ``schema`` (``TEST_SCHEMA`` by default);
    returns the rows written, for assertions."""
    schema = schema or TEST_SCHEMA
    rng = np.random.default_rng(seed)
    rows = [random_row(schema, rng, i) for i in range(num_rows)]
    write_dataset(url, schema, rows, row_group_size_rows=row_group_size_rows, **write_kwargs)
    return rows


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
