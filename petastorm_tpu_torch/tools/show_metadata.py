"""Operator CLI: inspect a dataset's schema, rowgroups, indexes and KV keys.

Counterpart of ``petastorm_tpu/tools/show_metadata.py`` (reference:
petastorm/etl/metadata_util.py:15-70).  One ``show`` surface prints what an
operator debugging a dataset needs (the schema with codecs and shapes, the
rowgroup count and row-count distribution, hive partition keys, stored
rowgroup indexes, legacy petastorm ones included, and the raw KV keys), and
``--json`` emits the same as one machine-readable document, the JAX tool's
document key for key.

Usage::

    petastorm-tpu-torch-metadata show file:///path/to/dataset
    petastorm-tpu-torch-metadata show --schema-only hdfs://ns/ds
    petastorm-tpu-torch-metadata show --rowgroups --json gs://bucket/ds
"""

from __future__ import annotations

import argparse
import json
import posixpath
import sys
from typing import List, Optional

from petastorm_tpu_torch.etl.indexing import get_row_group_indexes
from petastorm_tpu_torch.etl.metadata import (DatasetInfo, infer_or_load_schema,
                                        open_dataset)


def _schema_rows(info: DatasetInfo) -> List[dict]:
    schema = infer_or_load_schema(info)
    rows = []
    for field in schema:
        rows.append({
            "name": field.name,
            "dtype": str(field.dtype),
            "shape": list(field.shape),
            "codec": type(field.codec).__name__,
            "nullable": field.nullable,
        })
    return rows


def _rowgroup_summary(info: DatasetInfo) -> dict:
    sizes = sorted(rg.num_rows for rg in info.row_groups)
    n = len(sizes)
    return {
        "num_files": len(info.files),
        "num_row_groups": n,
        "total_rows": sum(sizes),
        "rows_per_group_min": sizes[0] if n else 0,
        "rows_per_group_median": sizes[n // 2] if n else 0,
        "rows_per_group_max": sizes[-1] if n else 0,
    }


def _per_file_rowgroups(info: DatasetInfo) -> List[dict]:
    per_file: dict = {}
    for rg in info.row_groups:
        per_file.setdefault(rg.path, []).append(rg.num_rows)
    return [{"file": posixpath.relpath(path, info.root_path),
             "row_groups": counts, "rows": sum(counts)}
            for path, counts in sorted(per_file.items())]


def _indexes(info: DatasetInfo) -> List[dict]:
    try:
        stored = get_row_group_indexes(info)
    except Exception as exc:  # noqa: BLE001 - inspection must not die on one key
        return [{"error": f"could not load stored indexes: {exc}"}]
    out = []
    for name, indexer in stored.items():
        values = indexer.indexed_values()
        out.append({
            "name": name,
            "type": type(indexer).__name__,
            "fields": list(indexer.column_names),
            "num_indexed_values": len(values),
            "sample_values": [str(v) for v in values[:8]],
        })
    return out


_ALL_SECTIONS = ("rowgroups", "files", "indexes")


def describe(url: str, storage_options: Optional[dict] = None,
             sections=_ALL_SECTIONS) -> dict:
    """Everything ``show`` prints, as one JSON-ready document.

    ``sections`` limits the expensive parts: loading stored rowgroup indexes
    materializes every indexed value, which --schema-only must not pay for.
    """
    info = open_dataset(url, storage_options=storage_options)
    doc = {
        "url": url,
        "root": info.root_path,
        "schema_source": ("stored" if info.stored_schema is not None
                          else "inferred-from-arrow"),
        "schema": _schema_rows(info),
        "partition_keys": info.partition_keys,
        "kv_metadata_keys": sorted(k.decode("utf-8", "replace")
                                   for k in info.kv_metadata),
    }
    if "rowgroups" in sections:
        doc["rowgroups"] = _rowgroup_summary(info)
    if "files" in sections:
        doc["files"] = _per_file_rowgroups(info)
    if "indexes" in sections:
        doc["indexes"] = _indexes(info)
    return doc


def _print_human(doc: dict, show_rowgroups: bool, schema_only: bool) -> None:
    print(f"Dataset: {doc['url']}")
    print(f"  schema source: {doc['schema_source']}")
    print("\nSchema:")
    widths = (max((len(r["name"]) for r in doc["schema"]), default=4),
              max((len(r["dtype"]) for r in doc["schema"]), default=5))
    for r in doc["schema"]:
        shape = "x".join("?" if d is None else str(d) for d in r["shape"]) or "scalar"
        null = " nullable" if r["nullable"] else ""
        print(f"  {r['name']:<{widths[0]}}  {r['dtype']:<{widths[1]}}  "
              f"{shape:<12} {r['codec']}{null}")
    if schema_only:
        return
    if doc["partition_keys"]:
        print(f"\nPartition keys: {', '.join(doc['partition_keys'])}")
    rg = doc["rowgroups"]
    print(f"\nRowgroups: {rg['num_row_groups']} across {rg['num_files']} files,"
          f" {rg['total_rows']} rows total")
    print(f"  rows/group min={rg['rows_per_group_min']}"
          f" median={rg['rows_per_group_median']}"
          f" max={rg['rows_per_group_max']}")
    if show_rowgroups:
        print("\nPer-file rowgroups:")
        for f in doc["files"]:
            print(f"  {f['file']}: {len(f['row_groups'])} groups,"
                  f" {f['rows']} rows {f['row_groups']}")
    if doc["indexes"]:
        print("\nStored rowgroup indexes:")
        for ix in doc["indexes"]:
            if "error" in ix:
                print(f"  {ix['error']}")
                continue
            print(f"  {ix['name']} ({ix['type']} on"
                  f" {', '.join(ix['fields'])}):"
                  f" {ix['num_indexed_values']} indexed values"
                  f" (sample: {', '.join(ix['sample_values'][:4])})")
    print("\nKV metadata keys:")
    for k in doc["kv_metadata_keys"]:
        print(f"  {k}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-metadata",
        description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    show = sub.add_parser("show", help="print dataset metadata")
    show.add_argument("url", help="dataset URL (file://, gs://, s3://, hdfs://)")
    show.add_argument("--schema-only", action="store_true",
                      help="print only the schema table")
    show.add_argument("--rowgroups", action="store_true",
                      help="also print per-file rowgroup row counts")
    show.add_argument("--json", action="store_true", dest="as_json",
                      help="emit one machine-readable JSON document")
    args = parser.parse_args(argv)

    if args.schema_only:
        sections = ()
    elif args.rowgroups:
        sections = _ALL_SECTIONS
    else:
        sections = ("rowgroups", "indexes")
    doc = describe(args.url, sections=sections)
    if args.as_json:
        if args.schema_only:
            doc = {"url": doc["url"], "schema_source": doc["schema_source"],
                   "schema": doc["schema"]}
        json.dump(doc, sys.stdout, indent=2)
        print()
    else:
        _print_human(doc, show_rowgroups=args.rowgroups,
                     schema_only=args.schema_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
