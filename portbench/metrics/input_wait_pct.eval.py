"""The share of an evaluation window the forward waited on the loader
(consumer_wait_s)."""

from portbench import readers

LAYER = "loader"
UNIT = "%"
MOVES = "eval_samples_per_s"


def read(record):
    return readers.input_wait_pct(record)
