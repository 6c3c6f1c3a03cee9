"""ResNet-50 v1.5's training operations a sample (3x the forward's convolutions
and dense layer) at the window's rate, over 989 TFLOP/s bf16."""

from portbench import readers

LAYER = "model step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(record):
    return readers.mfu_pct(record)
