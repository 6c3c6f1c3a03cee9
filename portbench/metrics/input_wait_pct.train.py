"""The share of a training window the step waited on the loader
(consumer_wait_s)."""

from portbench import readers

LAYER = "loader"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(record):
    return readers.input_wait_pct(record)
