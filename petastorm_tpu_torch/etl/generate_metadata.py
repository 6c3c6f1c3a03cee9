"""(Re)stamp a dataset's metadata: ``python -m petastorm_tpu_torch.etl.generate_metadata``.

Counterpart of ``petastorm_tpu/etl/generate_metadata.py``: regenerate
``_common_metadata`` (the schema, the per-file rowgroup counts and, with
``--scan-geometries``, the image-geometry contract) of a dataset whose
metadata is missing or stale, e.g. after an external engine added or
rewrote files.  The schema comes from, in order: an explicit
``--schema-from`` dataset, the schema JSON the data files carry, or (with
``--infer``) inference from the arrow schema.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.etl.metadata import infer_or_load_schema, open_dataset
from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata

logger = logging.getLogger(__name__)

_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _image_dims(buf: bytes) -> Optional[tuple]:
    """(h, w, c) from a PNG IHDR or the first JPEG SOF marker (no pixel
    decode), or None when the header is not recognized."""
    if len(buf) < 26:
        return None
    if buf[:8] == b"\x89PNG\r\n\x1a\n":
        w = int.from_bytes(buf[16:20], "big")
        h = int.from_bytes(buf[20:24], "big")
        channels = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(buf[25])
        return (h, w, channels) if channels else None
    if buf[:2] == b"\xff\xd8":  # jpeg SOI
        i = 2
        while i + 9 < len(buf):
            if buf[i] != 0xFF:
                i += 1
                continue
            marker = buf[i + 1]
            if marker == 0xFF:  # a fill byte, not a marker
                i += 1
                continue
            if marker in _JPEG_SOF:
                h = int.from_bytes(buf[i + 5:i + 7], "big")
                w = int.from_bytes(buf[i + 7:i + 9], "big")
                return (h, w, buf[i + 9])
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                i += 2  # standalone markers have no length field
                continue
            i += 2 + int.from_bytes(buf[i + 2:i + 4], "big")
    return None


def scan_geometries(dataset_url: str, schema=None) -> dict:
    """The distinct geometries of every variable-shape image column,
    ``{field: {(h, w, c), ...}}``, read from the encoded headers one
    rowgroup batch at a time.  ``schema``: the resolved schema when the
    dataset stores none yet (the ``--schema-from``/``--infer`` repairs)."""
    info = open_dataset(dataset_url, require_stored_schema=schema is None)
    if schema is None:
        schema = infer_or_load_schema(info)
    fields = [f.name for f in schema
              if isinstance(f.codec, CompressedImageCodec) and not f.is_fixed_shape]
    if not fields:
        return {}
    geoms: dict = {name: set() for name in fields}
    for path in info.files:
        with info.filesystem.open_input_file(path) as f:
            pf = pq.ParquetFile(f)
            present = [n for n in fields if n in pf.schema_arrow.names]
            if not present:
                continue
            for batch in pf.iter_batches(columns=present):
                for name in present:
                    for cell in batch.column(name):
                        buf = cell.as_py()
                        if buf is None:
                            continue
                        dims = _image_dims(bytes(buf))
                        if dims is not None:
                            geoms[name].add(dims)
    return {name: shapes for name, shapes in geoms.items() if shapes}


def generate_metadata(dataset_url: str, schema_from: Optional[str] = None,
                      infer: bool = False, rescan_geometries: bool = False) -> None:
    """Stamp ``_common_metadata`` of ``dataset_url`` anew.  A rescan's
    geometries replace the stamped ones (it saw the whole dataset); without
    one, the stamped geometries are kept."""
    schema = None
    if schema_from is not None:
        schema = infer_or_load_schema(open_dataset(schema_from, require_stored_schema=True))
    elif infer:
        schema = infer_or_load_schema(open_dataset(dataset_url))
    geometries = None
    if rescan_geometries:
        # an empty result stays {} (not None): it must replace a stale contract
        geometries = scan_geometries(dataset_url, schema=schema)
    stamp_dataset_metadata(dataset_url, schema=schema, geometries=geometries,
                           merge_geometries=not rescan_geometries)
    logger.info("Stamped metadata for %s", dataset_url)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="petastorm-tpu-torch-generate-metadata",
        description="Regenerate _common_metadata (schema + rowgroup counts)"
                    " for a dataset")
    parser.add_argument("dataset_url")
    parser.add_argument("--schema-from", default=None,
                        help="borrow the stored schema from another dataset URL")
    parser.add_argument("--infer", action="store_true",
                        help="infer the schema from the parquet arrow schema"
                             " when no stored schema exists")
    parser.add_argument("--scan-geometries", action="store_true",
                        help="scan variable-shape image columns (header-only"
                             " parse) and stamp the distinct shapes as the"
                             " dataset-level geometry contract, REPLACING any"
                             " already-stamped shapes")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    generate_metadata(args.dataset_url, schema_from=args.schema_from, infer=args.infer,
                      rescan_geometries=args.scan_geometries)
    print(f"metadata stamped: {args.dataset_url}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
