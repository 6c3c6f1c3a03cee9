"""B3 aa's antialiased resize (its table and separable kernels) in the profiled
evaluation stretch: least time over device time."""

from portbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "eval_samples_per_s"


def read(record):
    return readers.roofline_pct(record, "b3", readers.B3_KERNELS)
