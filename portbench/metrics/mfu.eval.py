"""ResNet-50 v1.5's forward operations a sample at the window's rate, over 989
TFLOP/s bf16."""

from portbench import readers

LAYER = "model step"
UNIT = "%"
MOVES = "eval_samples_per_s"


def read(record):
    return readers.mfu_pct(record)
