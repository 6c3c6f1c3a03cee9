"""The share of the profiled evaluation stretch in which no kernel, copy or
memset ran on the card."""

from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "eval_samples_per_s"


def read(record):
    return readers.device_idle_pct(record)
