"""The live host/device decode split (``decode_placement='auto'``) of the
port against the JAX package's, on the CPU.

After ``tests/test_batched_decode.py:367-445``: a flip while the loader runs
delivers every row exactly once; host-form pixels equal a plain host read
and device-form pixels stay within the JAX tolerance (max 6, mean < 1)
through B2's plain version; the loader never mixes forms in one batch; and
``set_decode_split`` without an ``'auto'`` field, like ``stack_batches``
over one, raises the JAX message.
"""

import multiprocessing

import numpy as np
import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.jax import JaxDataLoader

from petastorm_tpu_torch import Field, Schema, reader
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.ops import jpeg as jpeg_ops
from petastorm_tpu_torch.telemetry import Telemetry
from petastorm_tpu_torch.test_util.synthetic import synthetic_rgb_image


@pytest.fixture(autouse=True)
def _no_child_left():
    yield
    assert multiprocessing.active_children() == []


def _image_dataset(tmp_path, n_rows, rows_per_rg=8, hw=(64, 64)):
    url = str(tmp_path / "imgs")
    schema = Schema("Imgs", [
        Field("label", np.int64, (), ScalarCodec()),
        Field("image", np.uint8, hw + (3,), CompressedImageCodec("jpeg", quality=90)),
    ])
    write_dataset(url, schema, [{"label": i, "image": synthetic_rgb_image(i, *hw)}
                                for i in range(n_rows)], row_group_size_rows=rows_per_rg)
    return url


def _by_label(rdr):
    out = {}
    for b in rdr.iter_batches():
        for lab, img in zip(b.columns["label"], b.columns["image"]):
            out[int(lab)] = np.asarray(img)
    return out


EPOCHS = 3


def test_live_flip_delivers_the_exact_rows(tmp_path):
    url = _image_dataset(tmp_path, n_rows=96)
    labels, forms = [], []
    with reader.make_batch_reader(url, shuffle_row_groups=False, num_epochs=EPOCHS,
                                  workers_count=2, decode_placement={"image": "auto"}) as r:
        assert r.decode_split == "device" and r.device_decode_split == frozenset({"image"})
        with CudaDataLoader(r, 16, device="cpu", drop_last=False) as loader:
            for k, b in enumerate(loader):
                labels += [int(x) for x in b["label"][:b.get("_valid_rows", 16)]]
                assert tuple(b["image"].shape[1:]) == (64, 64, 3)
                assert b["image"].dtype.is_floating_point is False
                forms.append(loader.last_decode_form)
                if k == 0:
                    r.set_decode_split("host")
            diag = loader.diagnostics()
        assert r.decode_split == "host"
        assert r.diagnostics["decode_split"] == "host"
    assert sorted(labels) == sorted(list(range(96)) * EPOCHS)
    # the in-flight window decoded before the flip stays device form
    assert forms[0] == "device" and "host" in forms
    assert diag["decode_split_batches"] == {"host": forms.count("host"),
                                            "device": forms.count("device")}
    # the JAX loader delivers the same rows under the same flip
    jax_labels = []
    with jax_reader.make_batch_reader(url, shuffle_row_groups=False, num_epochs=EPOCHS,
                                      workers_count=2,
                                      decode_placement={"image": "auto"}) as r:
        with JaxDataLoader(r, batch_size=16, drop_last=False) as loader:
            for k, b in enumerate(loader):
                jax_labels += [int(x) for x in np.asarray(b["label"])]
                if k == 0:
                    r.set_decode_split("host")
    assert sorted(jax_labels) == sorted(labels)


def _read_split(url, mode):
    """label -> image of epoch 2 with the split set to ``mode`` before the
    loader drains: one worker and a results bound below an epoch, so every
    epoch-2 rowgroup decodes in the requested form (the JAX test's throttle)."""
    out, forms = {}, set()
    with reader.make_batch_reader(url, shuffle_row_groups=False, num_epochs=2,
                                  workers_count=1, results_queue_size=2, autotune=False,
                                  decode_placement={"image": "auto"}) as r:
        r.set_decode_split(mode)
        with CudaDataLoader(r, 8, device="cpu") as loader:
            for b in loader:
                forms.add(loader.last_decode_form)
                for lab, img in zip(b["label"].numpy(), b["image"].numpy()):
                    out[int(lab)] = img
    return out, forms


def test_host_form_equals_a_host_read_and_device_form_is_within_the_jax_tolerance(
        tmp_path, monkeypatch):
    url = _image_dataset(tmp_path, n_rows=32)
    with reader.make_batch_reader(url, shuffle_row_groups=False) as r:
        expect = _by_label(r)
    with jax_reader.make_batch_reader(url, shuffle_row_groups=False) as r:
        jax_expect = _by_label(r)
    for lab in expect:
        assert (expect[lab] == jax_expect[lab]).all()
    calls = []
    plain = jpeg_ops._decode_reference  # noqa: SLF001

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(jpeg_ops, "_decode_reference", counted)
    host, host_forms = _read_split(url, "host")
    assert "host" in host_forms
    for lab in expect:
        assert (host[lab] == expect[lab]).all()
    device, device_forms = _read_split(url, "device")
    assert device_forms == {"device"} and calls
    for lab in expect:
        diff = np.abs(device[lab].astype(int) - expect[lab].astype(int))
        assert diff.max() <= 6 and diff.mean() < 1.0


def test_a_batch_never_mixes_forms(tmp_path):
    url = _image_dataset(tmp_path, n_rows=64, rows_per_rg=4)
    with reader.make_batch_reader(url, shuffle_row_groups=True, shuffle_seed=3, num_epochs=1,
                                  workers_count=2, decode_placement={"image": "auto"}) as r:
        with CudaDataLoader(r, 12, device="cpu", shuffling_queue_capacity=40,
                            drop_last=False) as loader:
            labels = []
            for k, b in enumerate(loader):
                # each form's buffer pads its own tail
                rows = b.get("_valid_rows", len(b["label"]))
                labels += [int(x) for x in b["label"][:rows]]
                r.set_decode_split(k % 2 == 0 and "host" or "device")
                assert loader.last_decode_form in ("host", "device")
    assert sorted(labels) == list(range(64))


def test_split_gauges_and_cache_keys(tmp_path):
    url = _image_dataset(tmp_path, n_rows=32)
    tele = Telemetry()
    with reader.make_batch_reader(url, shuffle_row_groups=False, num_epochs=3,
                                  workers_count=1, results_queue_size=1, telemetry=tele,
                                  cache_type="memory",
                                  decode_placement={"image": "auto"}) as r:
        assert r.set_decode_split("host") == 0 and r.set_decode_split(1) == 1
        assert r.set_decode_split(False) == 0
        with CudaDataLoader(r, 8, device="cpu") as loader:
            labels = [int(x) for b in loader for x in b["label"]]
        stats = r.cache_stats()
    snap = tele.snapshot()
    assert snap["gauges"]["decode.split"] == 0
    assert snap["counters"]["decode.split_to_host"] == 2
    assert snap["counters"]["decode.split_to_device"] == 1
    assert sorted(labels) == sorted(list(range(32)) * 3)
    # entries are keyed by the split side: a flip never serves the other form
    assert stats["hits"] + stats["misses"] == 12


def test_set_decode_split_without_an_auto_field_raises_the_jax_message(tmp_path):
    url = _image_dataset(tmp_path, n_rows=8)
    messages = []
    for mod, error in ((jax_reader, JaxPetastormTpuError), (reader, PetastormTpuError)):
        with mod.make_batch_reader(url, shuffle_row_groups=False) as r:
            assert r.decode_split is None
            with pytest.raises(error, match="decode_placement") as exc:
                r.set_decode_split("host")
            messages.append(str(exc.value))
        with mod.make_batch_reader(url, shuffle_row_groups=False,
                                   decode_placement={"image": "auto"}) as r:
            with pytest.raises(error) as exc:
                r.set_decode_split("sideways")
            messages.append(str(exc.value))
    assert messages[2:] == messages[:2]


def test_stack_batches_over_a_split_field_raises_the_jax_message(tmp_path):
    url = _image_dataset(tmp_path, n_rows=32)
    messages = []
    with jax_reader.make_batch_reader(url, shuffle_row_groups=False,
                                      decode_placement={"image": "auto"}) as r:
        with pytest.raises(JaxPetastormTpuError, match="stack_batches") as exc:
            JaxDataLoader(r, batch_size=8, stack_batches=2)
        messages.append(str(exc.value))
    with reader.make_batch_reader(url, shuffle_row_groups=False,
                                  decode_placement={"image": "auto"}) as r:
        with pytest.raises(PetastormTpuError, match="stack_batches") as exc:
            CudaDataLoader(r, 8, device="cpu", stack_batches=2)
        messages.append(str(exc.value))
    assert messages[1] == messages[0]


def test_seed_readers_do_not_tune_the_split(tmp_path):
    url = _image_dataset(tmp_path, n_rows=16)
    with reader.make_batch_reader(url, shuffle_seed=1, autotune=True,
                                  decode_placement={"image": "auto"}) as r:
        assert r.deterministic == "seed"
        assert "decode_split" in r.autotune.policy.exclude_knobs
        assert "decode_split" not in r.autotune.knobs()
    with reader.make_batch_reader(url, deterministic="off", autotune=True,
                                  decode_placement={"image": "auto"}) as r:
        assert r.autotune.knobs()["decode_split"] == 1
