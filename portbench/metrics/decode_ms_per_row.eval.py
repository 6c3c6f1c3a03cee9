"""Host decode ms a row in an evaluation window, from the workers' decode stage
spans."""

from portbench import readers

LAYER = "reader/pool/worker decode"
UNIT = "ms"
MOVES = "eval_samples_per_s"


def read(record):
    return readers.decode_ms_per_row(record)
