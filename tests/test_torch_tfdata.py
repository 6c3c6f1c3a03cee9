"""The trainer's tf.data comparator (``--input tfdata``) against the JAX package's, on the CPU.

The same Parquet dataset goes through both packages' ``build_tfrecord``
(the TFRecord files must be equal byte for byte) and both
``TfdataDeviceFeed`` classes.  The feeds map with ``deterministic=False``,
as the reference does, so their batches are compared row by row through
the labels, which are unique here: every delivered (label, image) pair must
be the same in both feeds and equal to tf.data's own decode of that row.
Images are compared exactly (both are ``tf.io.decode_jpeg``).
"""

import numpy as np
import pyarrow.dataset as pads
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from examples.imagenet import train_resnet_tpu as jax_trainer  # noqa: E402
from petastorm_tpu_torch import CompressedImageCodec, Field, ScalarCodec, Schema, \
    write_dataset  # noqa: E402
from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer  # noqa: E402

ROWS, SIDE, BATCH = 40, 32, 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """ROWS rows with unique labels (the row index) and random images, JPEG q90."""
    rng = np.random.default_rng(0)
    schema = Schema("ImagenetLike", [
        Field("label", np.int64, (), ScalarCodec()),
        Field("image", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90))])
    url = str(tmp_path_factory.mktemp("tfdata") / "imagenet")
    write_dataset(url, schema, ({"label": i, "image": rng.integers(0, 255, (SIDE, SIDE, 3))
                                 .astype(np.uint8)} for i in range(ROWS)),
                  row_group_size_rows=8)
    return url


@pytest.fixture(scope="module")
def tfrecords(dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("tfr")
    port, jax_path = str(root / "port.tfrecord"), str(root / "jax.tfrecord")
    trainer.build_tfrecord(dataset, port)
    jax_trainer.build_tfrecord(dataset, jax_path)
    return port, jax_path


def _decoded_rows(dataset):
    """label -> tf.data's decode of the row's stored JPEG."""
    table = pads.dataset(dataset, format="parquet").to_table(columns=["label", "image"])
    return {int(label): tf.io.decode_jpeg(image, channels=3).numpy()
            for label, image in zip(table.column("label").to_pylist(),
                                    table.column("image").to_pylist())}


def test_build_tfrecord_equals_the_jax_packages(tfrecords, dataset):
    port, jax_path = tfrecords
    with open(port, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    labels = [int(tf.train.Example.FromString(raw.numpy()).features.feature["label"]
                  .int64_list.value[0]) for raw in tf.data.TFRecordDataset(port)]
    table = pads.dataset(dataset, format="parquet").to_table(columns=["label"])
    assert labels == table.column("label").to_pylist()


def test_feed_gives_the_jax_feeds_rows(tfrecords, dataset):
    port, _ = tfrecords
    rows = _decoded_rows(dataset)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    with jax_trainer.TfdataDeviceFeed(port, BATCH, 2, sharding, sharding) as feed:
        want = [{k: np.asarray(v) for k, v in next(feed).items()} for _ in range(4)]
    with trainer.TfdataDeviceFeed(port, BATCH, 2, "cpu") as feed:
        got = [next(feed) for _ in range(4)]
        assert feed.consumer_wait_s >= 0.0
    want_rows = {int(label): image for b in want for label, image in zip(b["label"], b["image"])}
    for batch in got:
        assert batch["image"].dtype == torch.uint8 and batch["label"].dtype == torch.int64
        assert tuple(batch["image"].shape) == (BATCH, SIDE, SIDE, 3)
        for label, image in zip(batch["label"].tolist(), batch["image"].numpy()):
            np.testing.assert_array_equal(image, rows[label])
            if label in want_rows:
                np.testing.assert_array_equal(image, want_rows[label])
    got_labels = {label for b in got for label in b["label"].tolist()}
    assert len(got_labels) == len(want_rows) == 4 * BATCH  # 32 of the 40 rows, no repeat


def test_scan_steps_stack_tfdata_batches(tfrecords, dataset, monkeypatch):
    """``input_pipeline='tfdata'`` with ``scan_steps=2``: each unit stacks two
    tf.data batches, (2, B, H, W, 3) images and (2, B) labels, every row
    tf.data's decode of its labelled JPEG."""
    rows = _decoded_rows(dataset)
    units = []
    real = trainer.ScanStep.__call__

    def recording(self, images, labels, boxes=None, flips=None):
        units.append((images.clone(), labels.clone()))
        return real(self, images, labels, boxes, flips)

    monkeypatch.setattr(trainer.ScanStep, "__call__", recording)
    m = trainer.train(dataset, steps=2, global_batch=BATCH, side=SIDE, num_classes=10,
                      device="cpu", scan_steps=2, input_pipeline="tfdata")
    assert m["input"] == "tfdata" and m["decode"] == "tfdata-host" and m["steps"] == 2
    assert m["cache_stats"] is None and np.isfinite(m["final_loss"])
    assert len(units) == 3  # warm-up, one timed unit, the resident unit
    for images, labels in units:
        assert tuple(images.shape) == (2, BATCH, SIDE, SIDE, 3) and labels.shape == (2, BATCH)
        for image, label in zip(images.flatten(0, 1).numpy(), labels.flatten().tolist()):
            np.testing.assert_array_equal(image, rows[label])


def test_tfdata_without_tensorflow_raises(dataset, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="needs tensorflow"):
        trainer.train(dataset, steps=1, global_batch=BATCH, side=SIDE, num_classes=10,
                      device="cpu", input_pipeline="tfdata")
