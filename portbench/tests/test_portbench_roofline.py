"""The yardstick's counts against hand counts at small shapes."""

import pytest
import torch

from portbench import roofline


def test_resnet50_multiply_adds_at_32_pixels_and_10_classes():
    # stem: 16 x 16 outputs of 64 channels, 3 x 7 x 7 taps; the max-pool leaves 8 x 8
    stem = 16 * 16 * 64 * 3 * 49
    # a block after the first of its stage: 1x1 down, 3x3, 1x1 up; the spatial
    # side halves as the width doubles, so every stage's such block costs the same
    later = 8 * 8 * 64 * 256 + 8 * 8 * 64 * 64 * 9 + 8 * 8 * 256 * 64
    first0 = 8 * 8 * 64 * 64 + 8 * 8 * 64 * 64 * 9 + 8 * 8 * 256 * 64 + 8 * 8 * 256 * 64
    # stages 1-3's first block: 1x1 at the input side, stride-2 3x3, 1x1 up, projection
    first = 8 * 8 * 128 * 256 + 4 * 4 * 128 * 128 * 9 + 4 * 4 * 512 * 128 + 4 * 4 * 512 * 256
    dense = 2048 * 10
    macs = stem + first0 + 3 * first + (2 + 3 + 5 + 2) * later + dense
    assert macs == 83_431_424
    assert roofline.resnet50_forward_flops(32, 10) == 2 * macs
    assert roofline.resnet50_train_flops(32, 10) == 6 * macs


def test_resnet50_at_224_is_the_published_four_billion_multiply_adds():
    macs = roofline.resnet50_forward_flops(224, 1000) / 2
    assert macs == pytest.approx(4.09e9, rel=0.01)
    assert len(roofline.resnet50_layers()) == 53 + 1  # 53 convolutions and the dense layer


def test_crop_bytes_and_operations_by_hand():
    # a 4 x 6 one-channel image, the whole of it to 2 x 3: each output samples
    # the middle of two source pixels on each axis
    work = roofline.resample_work((4, 6, 1), torch.tensor([[0.0, 0.0, 4.0, 6.0]]), (2, 3),
                                  antialias=False)
    rows_first = 4 * 6 + 2 * 6  # 4 row taps over 6 columns, then 2 x 3 column taps
    assert work == {"bytes": 4 * 6 + 2 * 3, "flops": 2 * rows_first}


def test_crop_reads_only_the_box_on_a_larger_canvas():
    boxed = roofline.resample_work((40, 60, 3), torch.tensor([[10.0, 20.0, 4.0, 6.0]]), (2, 3),
                                   antialias=False)
    whole = roofline.resample_work((4, 6, 3), torch.tensor([[0.0, 0.0, 4.0, 6.0]]), (2, 3),
                                   antialias=False)
    assert boxed == whole


def test_antialias_widens_the_taps_of_a_downscale():
    box = torch.tensor([[0.0, 0.0, 8.0, 8.0]])
    plain = roofline.resample_work((8, 8, 1), box, (2, 2), antialias=False)
    wide = roofline.resample_work((8, 8, 1), box, (2, 2), antialias=True)
    assert plain["bytes"] == 4 * 4 + 4 and wide["bytes"] == 8 * 8 + 4
    assert wide["flops"] > plain["flops"]


def test_jpeg_work_of_one_420_mcu_by_hand():
    work = roofline.jpeg_work(16, 16, "4:2:0")
    blocks = 4 + 1 + 1
    idct = blocks * (64 + 2 * 2 * 512 + 64)
    upsample = 2 * (3 * 16 * 8 + 3 * 16 * 16)  # each chroma plane: vertical, then horizontal
    color = 8 * 16 * 16
    assert work["flops"] == idct + upsample + color
    assert work["bytes"] == blocks * 64 * 2 + 3 * 64 * 4 + 16 * 16 * 3


def test_jpeg_work_of_gray_and_444_pads_to_whole_blocks():
    gray = roofline.jpeg_work(9, 17, "gray")
    assert gray["bytes"] == 2 * 3 * 64 * 2 + 64 * 4 + 9 * 17
    full = roofline.jpeg_work(8, 8, "4:4:4")
    assert full["flops"] == 3 * (64 + 2048 + 64) + 8 * 64


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds({"bytes": 3.35e12, "flops": 0.0}) == pytest.approx(1.0)
    assert roofline.least_seconds({"bytes": 0.0, "flops": 134e12}) == pytest.approx(2.0)
