"""The JPEG corpus of a configuration, written from the run's seed.

A copy of the pattern of ``chip_smoke.py``'s ``write_mixed_corpus`` (phase
21), parameterised by the configuration's ``corpus`` entry and the seed:
each row's geometry is drawn with the configuration's weights, its content
is a smooth field (a small random grid, cubic-resized) plus one of a few
shared noise fields, encoded by OpenCV at the stated quality and chroma
subsampling.  The noise level sets the mean stream size, which the
configuration states (ILSVRC-2012's mean, about 110 KB).

Rows carry ``row_id`` (the row's index in the corpus), ``label``,
``height``, ``width`` and ``image`` (``(None, None, 3)``, JPEG).  A grayscale
geometry is stored as a one-channel JPEG, as ImageNet stores its grayscale
photographs; the decoders give it three equal channels.

:func:`write_corpus` writes the Parquet file and the dataset's metadata and
returns a :class:`Corpus`, which keeps each row's geometry, label and
stream, so the reference and the roofline arithmetic never ask the program.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

SAMPLING_FLAGS = {"4:2:0": "IMWRITE_JPEG_SAMPLING_FACTOR_420",
                  "4:4:4": "IMWRITE_JPEG_SAMPLING_FACTOR_444"}


@dataclasses.dataclass
class Corpus:
    """A written corpus: its directory and, by row, what was written."""

    path: str
    kinds: np.ndarray            # (rows,) index into ``geometries``
    labels: np.ndarray           # (rows,) int64
    heights: np.ndarray          # (rows,) int64
    widths: np.ndarray           # (rows,) int64
    streams: List[bytes]
    geometries: Sequence[Dict]   # the configuration's geometry entries

    @property
    def rows(self) -> int:
        return len(self.streams)

    def mean_stream_bytes(self) -> float:
        return float(np.mean([len(s) for s in self.streams]))

    def sampling(self, row: int) -> str:
        """``'4:2:0'``, ``'4:4:4'`` or ``'gray'``."""
        geometry = self.geometries[int(self.kinds[row])]
        return "gray" if geometry.get("gray") else geometry.get("sampling", "4:2:0")


def draw_rows(spec: Dict, rows: int, seed: int) -> Dict[str, np.ndarray]:
    """Each row's geometry kind and label, and the content's random parts."""
    rng = np.random.default_rng(seed)
    geometries = spec["geometries"]
    weights = np.array([g["weight"] for g in geometries], np.float64)
    kinds = rng.choice(len(geometries), rows, p=weights / weights.sum())
    labels = rng.integers(0, int(spec["num_classes"]), rows).astype(np.int64)
    grid = int(spec["smooth_grid"])
    lows = rng.integers(0, 256, (rows, grid, grid, 3)).astype(np.float32)
    side = max(max(g["height"], g["width"]) for g in geometries)
    noise = rng.normal(0.0, float(spec["noise_sigma"]),
                       (int(spec["noise_fields"]), side, side, 3)).astype(np.float32)
    return {"kinds": kinds, "labels": labels, "lows": lows, "noise": noise}


def encode_row(spec: Dict, drawn: Dict[str, np.ndarray], row: int) -> bytes:
    """Row ``row``'s JPEG stream."""
    import cv2

    geometry = spec["geometries"][int(drawn["kinds"][row])]
    h, w = int(geometry["height"]), int(geometry["width"])
    noise = drawn["noise"]
    img = (cv2.resize(drawn["lows"][row], (w, h), interpolation=cv2.INTER_CUBIC)
           + noise[row % len(noise), :h, :w])
    img = np.clip(img, 0, 255).astype(np.uint8)
    params = [int(cv2.IMWRITE_JPEG_QUALITY), int(spec["quality"])]
    if geometry.get("gray"):
        img = np.ascontiguousarray(img[..., 0])
    else:
        flag = SAMPLING_FLAGS[geometry.get("sampling", "4:2:0")]
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(getattr(cv2, flag))]
        img = img[..., ::-1]  # cv2 encodes BGR; the stream holds RGB
    ok, enc = cv2.imencode(".jpeg", img, params)
    if not ok:
        raise RuntimeError(f"cv2.imencode failed for corpus row {row}")
    return enc.tobytes()


def corpus_schema():
    from petastorm_tpu_torch import CompressedImageCodec, Field, ScalarCodec, Schema

    return Schema("PortbenchImagenet", [
        Field("row_id", np.int64, (), ScalarCodec()),
        Field("label", np.int64, (), ScalarCodec()),
        Field("height", np.int64, (), ScalarCodec()),
        Field("width", np.int64, (), ScalarCodec()),
        Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg", quality=90)),
    ])


def write_corpus(spec: Dict, rows: int, seed: int, root: str, threads: int = 0) -> Corpus:
    """Write ``rows`` rows of ``spec`` (a configuration's ``corpus`` entry)
    for ``seed`` into ``root/corpus`` (a Parquet file in rowgroups of
    ``rows_per_group`` and its metadata, with the geometry contract)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl.writer import stamp_dataset_metadata

    drawn = draw_rows(spec, rows, seed)
    with ThreadPoolExecutor(max_workers=threads or os.cpu_count() or 2) as pool:
        streams = list(pool.map(lambda i: encode_row(spec, drawn, i), range(rows)))
    geometries = spec["geometries"]
    heights = np.array([geometries[k]["height"] for k in drawn["kinds"]], np.int64)
    widths = np.array([geometries[k]["width"] for k in drawn["kinds"]], np.int64)
    path = os.path.join(root, "corpus")
    os.makedirs(path)
    schema = corpus_schema()
    table = pa.table({"row_id": pa.array(np.arange(rows, dtype=np.int64)),
                      "label": pa.array(drawn["labels"]), "height": pa.array(heights),
                      "width": pa.array(widths), "image": pa.array(streams, pa.binary())},
                     schema=schema.as_arrow_schema())
    pq.write_table(table, os.path.join(path, "part-00000.parquet"),
                   row_group_size=int(spec["rows_per_group"]))
    stamp_dataset_metadata(path, schema, geometries={"image": sorted(
        {(g["height"], g["width"], 1 if g.get("gray") else 3) for g in geometries})})
    return Corpus(path, drawn["kinds"], drawn["labels"], heights, widths, streams, geometries)
