"""B3's tiled crop and flip in the profiled training stretch: its least time
(bytes of each box's source region and of the output at 3.35 TB/s, or
operations at 67 TFLOP/s) over its device time."""

from portbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(record):
    return readers.roofline_pct(record, "b3", readers.B3_KERNELS)
