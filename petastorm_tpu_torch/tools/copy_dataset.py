"""``petastorm-tpu-torch-copy-dataset``: copy a dataset with an optional
column subset and not-null row filtering.

Counterpart of ``petastorm_tpu/tools/copy_dataset.py`` (reference:
petastorm/tools/copy_dataset.py:35-91, ``--field-regex`` and
``--not-null-fields``): the copy streams decoded rows from the port's reader
into its ``write_dataset``, the codecs kept through the source schema's view.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional, Sequence

from petastorm_tpu_torch.predicates import in_lambda, in_reduce
from petastorm_tpu_torch.reader import make_reader

logger = logging.getLogger(__name__)


def copy_dataset(source_url: str,
                 target_url: str,
                 field_regex: Optional[Sequence[str]] = None,
                 not_null_fields: Optional[Sequence[str]] = None,
                 overwrite_output: bool = False,
                 partitions_count: Optional[int] = None,
                 row_group_size_mb: Optional[float] = None,
                 rows_per_file: Optional[int] = None,
                 jpeg_quality: Optional[int] = None,
                 encode_workers: int = 1,
                 storage_options: Optional[dict] = None) -> int:
    """Copy ``source_url`` -> ``target_url``; returns rows copied.

    ``field_regex``: keep only fields matching any regex (reference
    copy_dataset.py:44-49).  ``not_null_fields``: drop rows where any named
    field is null (copy_dataset.py:51-54).

    The copy decodes through the source codecs and re-encodes through the
    target schema's, so jpeg fields come out with ONE uniform geometry and
    subsampling - the migration path for datasets whose mixed encoder
    settings block ``decode_placement='device'``.  ``jpeg_quality`` overrides
    the stored quality of every jpeg field in the target.
    """
    from petastorm_tpu_torch.etl.writer import write_dataset

    predicate = None
    if not_null_fields:
        predicate = in_reduce(
            [in_lambda([f], lambda cols, _f=f: _not_null_mask(cols[_f]),
                       vectorized=True) for f in not_null_fields])

    with make_reader(source_url, schema_fields=list(field_regex) if field_regex
                     else None,
                     predicate=predicate, shuffle_row_groups=False,
                     num_epochs=1, storage_options=storage_options) as reader:
        schema = reader.schema
        if jpeg_quality is not None:
            schema = _with_jpeg_quality(schema, jpeg_quality)
        count = 0

        def rows():
            nonlocal count
            for batch in reader.iter_batches():
                for i in range(batch.num_rows):
                    count += 1
                    yield {name: col[i] for name, col in batch.columns.items()}

        write_dataset(target_url, schema, rows(),
                      row_group_size_mb=row_group_size_mb,
                      rows_per_file=rows_per_file,
                      storage_options=storage_options,
                      encode_workers=encode_workers,
                      mode="overwrite" if overwrite_output else "error")
    logger.info("Copied %d rows from %s to %s", count, source_url, target_url)
    return count


def _with_jpeg_quality(schema, quality: int):
    """Source schema with every jpeg CompressedImageCodec's quality replaced."""
    import dataclasses

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.schema import Schema

    fields = [
        dataclasses.replace(f, codec=CompressedImageCodec("jpeg",
                                                          quality=quality))
        if isinstance(f.codec, CompressedImageCodec)
        and f.codec.image_codec == "jpeg" else f
        for f in schema]
    return Schema(schema.name, fields)


def _not_null_mask(col):
    import numpy as np
    if col.dtype == object:
        return np.asarray([v is not None for v in col], dtype=bool)
    if col.dtype.kind == "f":
        return ~np.isnan(col)
    return np.ones(len(col), dtype=bool)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-copy-dataset",
        description="Copy a petastorm-tpu dataset, optionally subsetting columns"
                    " and dropping rows with nulls")
    parser.add_argument("source_url")
    parser.add_argument("target_url")
    parser.add_argument("--field-regex", nargs="+", default=None)
    parser.add_argument("--not-null-fields", nargs="+", default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--row-group-size-mb", type=float, default=None)
    parser.add_argument("--rows-per-file", type=int, default=None)
    parser.add_argument("--jpeg-quality", type=int, default=None,
                        help="re-encode jpeg fields at this quality (the copy"
                             " always re-encodes uniformly - use this to"
                             " migrate mixed-geometry datasets for"
                             " decode_placement='device')")
    parser.add_argument("--encode-workers", type=int, default=1,
                        help="parallelize the re-encode across N threads"
                             " (jpeg/png encoding releases the GIL)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    n = copy_dataset(args.source_url, args.target_url,
                     field_regex=args.field_regex,
                     not_null_fields=args.not_null_fields,
                     overwrite_output=args.overwrite,
                     row_group_size_mb=args.row_group_size_mb,
                     rows_per_file=args.rows_per_file,
                     jpeg_quality=args.jpeg_quality,
                     encode_workers=args.encode_workers)
    print(f"copied {n} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
