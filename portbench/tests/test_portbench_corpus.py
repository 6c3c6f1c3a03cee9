"""The corpus writer: its geometry weights, its mean stream size, its
determinism in the seed and the dataset the port reads."""

import os

import numpy as np
import pytest

from portbench import corpus as corpus_mod
from portbench import run

CONFIG = run.load_json(os.path.join(run.ROOT, "portbench", "configs", "imagenet_train_rn50.json"))
SPEC = CONFIG["corpus"]


def test_the_geometry_weights_hold_over_many_rows():
    drawn = corpus_mod.draw_rows(SPEC, 20000, 11)
    shares = np.bincount(drawn["kinds"], minlength=len(SPEC["geometries"])) / 20000
    want = [g["weight"] for g in SPEC["geometries"]]
    assert np.allclose(shares, want, atol=0.01)
    assert drawn["labels"].min() >= 0 and drawn["labels"].max() < SPEC["num_classes"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return corpus_mod.write_corpus(SPEC, 200, 2**40 + 3, str(tmp_path_factory.mktemp("c")),
                                   threads=4)


def test_the_mean_stream_is_near_ilsvrc_trains(small):
    # ILSVRC-2012 train: about 138 GB over 1,281,167 images
    assert 90e3 <= small.mean_stream_bytes() <= 130e3


def test_rows_carry_their_geometry_and_grayscale_streams_one_channel(small):
    import cv2

    for row in range(0, small.rows, 7):
        img = cv2.imdecode(np.frombuffer(small.streams[row], np.uint8), cv2.IMREAD_UNCHANGED)
        assert img.shape[:2] == (small.heights[row], small.widths[row])
        assert (img.ndim == 2) == (small.sampling(row) == "gray")


def test_the_same_seed_writes_the_same_corpus(tmp_path):
    a = corpus_mod.write_corpus(SPEC, 6, 5, str(tmp_path / "a"), threads=2)
    b = corpus_mod.write_corpus(SPEC, 6, 5, str(tmp_path / "b"), threads=2)
    c = corpus_mod.write_corpus(SPEC, 6, 6, str(tmp_path / "c"), threads=2)
    assert a.streams == b.streams and np.array_equal(a.labels, b.labels)
    assert a.streams != c.streams


def test_the_port_reads_every_row_once_an_epoch(small):
    from petastorm_tpu_torch import make_reader

    with make_reader(small.path, num_epochs=1, shuffle_seed=3, workers_count=2,
                     decode_placement={"image": "host"}) as reader:
        ids = sorted(int(row.row_id) for row in reader)
    assert ids == list(range(small.rows))
