"""Host decode ms a row (Parquet read and JPEG decode, or the entropy decode
alone on the mixed route) in a training window, from the workers' decode
stage spans."""

from portbench import readers

LAYER = "reader/pool/worker decode"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(record):
    return readers.decode_ms_per_row(record)
