"""The port's static pipeline planner against the JAX package's, on the CPU.

On the same dataset, fields, policy and core count both packages give the
same footer summary, dataset fingerprint and schema hash, and the same
planned knobs with the same provenance (pinned > profile > metadata >
default).  A profile written at reader stop round-trips into the next
reader's plan, and a corrupt or mismatched profile warns and falls back to
the metadata pass.
"""

import json
import logging
import os

import numpy as np
import pytest

from petastorm_tpu import autotune as jax_autotune
from petastorm_tpu import planner as jax_planner
from petastorm_tpu.etl.metadata import open_dataset as jax_open_dataset

from petastorm_tpu_torch import Field, Schema, autotune, planner, reader
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.etl.metadata import open_dataset
from petastorm_tpu_torch.etl.writer import write_dataset

PKG = {"jax": (jax_planner, jax_autotune, jax_open_dataset),
       "torch": (planner, autotune, open_dataset)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """An image dataset (decode-heavy) and a narrow columnar one."""
    root = tmp_path_factory.mktemp("planner")
    rng = np.random.default_rng(8)
    images = str(root / "images")
    write_dataset(images, Schema("Img", [
        Field("x", np.int64),
        Field("image", np.uint8, (24, 24, 3), CompressedImageCodec("png")),
    ]), [{"x": i, "image": rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)}
         for i in range(64)], row_group_size_rows=8)
    narrow = str(root / "narrow")
    write_dataset(narrow, Schema("Narrow", [Field("a", np.int64), Field("b", np.float32)]),
                  [{"a": i, "b": float(i) / 3} for i in range(400)], row_group_size_rows=50)
    return {"images": images, "narrow": narrow}


def _infos(url):
    return {pkg: PKG[pkg][2](url) for pkg in PKG}


@pytest.mark.parametrize("name,fields", [("images", ["x", "image"]), ("images", ["x"]),
                                         ("narrow", ["a", "b"])])
def test_footer_fingerprint_and_schema_hash_equal_jax(datasets, name, fields):
    infos = _infos(datasets[name])
    want = jax_planner.footer_stats(infos["jax"], fields)
    got = planner.footer_stats(infos["torch"], fields)
    assert got == want and got["rowgroups_total"] == len(infos["torch"].row_groups)
    assert planner.dataset_fingerprint(infos["torch"]) == \
        jax_planner.dataset_fingerprint(infos["jax"])
    assert planner.schema_hash(fields, "sig") == jax_planner.schema_hash(fields, "sig")
    assert planner.SOURCES == jax_planner.SOURCES
    assert planner.PROFILE_VERSION == jax_planner.PROFILE_VERSION


CASES = [
    dict(),
    dict(workers_count=3),
    dict(decode_threads=2),
    dict(results_queue_size=7, results_queue_pinned=True),
    dict(cache_type="shared"),
    dict(split_fields=("image",)),
    dict(image_fields=("image",)),
    dict(workers_count=5, decode_threads=1, cache_type="shared", image_fields=("image",)),
]


@pytest.mark.parametrize("name", ["images", "narrow"])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("cores", [1, 4, 32])
def test_plan_reader_knobs_and_provenance_equal_jax(datasets, tmp_path, name, case, cores):
    infos = _infos(datasets[name])
    fields = [f.name for f in infos["torch"].stored_schema] if infos["torch"].stored_schema \
        else ["a", "b"]
    plans = {}
    for pkg in PKG:
        plan_mod, auto_mod = PKG[pkg][:2]
        kwargs = dict(CASES[case])
        verdict = plan_mod.plan_reader(infos[pkg], fields, policy=auto_mod.AutotunePolicy(),
                                       cores=cores, cache_location=str(tmp_path / pkg),
                                       transform_signature="-", **kwargs)
        plans[pkg] = {k: (v.value, v.source, v.why) for k, v in verdict.knobs.items()}
        assert verdict.profile is None
    assert plans["torch"] == plans["jax"]


def _read_autotuned(url, location, **kwargs):
    policy = autotune.AutotunePolicy(warmup_s=1e6, **kwargs)
    with reader.make_batch_reader(url, shuffle_seed=1, workers_count="auto", autotune=policy,
                                  cache_location=location) as r:
        rows = sum(len(b[0]) for b in r)
        verdict = r.diagnostics["planner"]
    return rows, verdict


def test_profile_round_trip(datasets, tmp_path):
    location = str(tmp_path / "profiles")
    rows, first = _read_autotuned(datasets["images"], location)
    assert rows == 64 and first["profile"] is None
    assert first["knobs"]["workers"]["source"] in ("metadata", "default")
    assert os.path.exists(first["profile_path"])
    with open(first["profile_path"]) as f:
        stored = json.load(f)
    assert stored["version"] == planner.PROFILE_VERSION and stored["source"] == "autotune"
    assert stored["fingerprint"] == first["fingerprint"]
    _, second = _read_autotuned(datasets["images"], location)
    assert second["knobs"]["workers"]["source"] == "profile"
    assert second["knobs"]["workers"]["value"] == stored["knobs"]["workers"]
    assert second["profile"]["knobs"] == stored["knobs"]
    # the port's profiles sit under its own location, never the JAX package's
    assert planner.default_profile_location().endswith("petastorm_tpu_torch_warm")


@pytest.mark.parametrize("damage", ["corrupt", "stale_version", "other_fingerprint"])
def test_a_bad_profile_warns_and_falls_back_to_metadata(datasets, tmp_path, damage, caplog):
    location = str(tmp_path / "profiles")
    _, first = _read_autotuned(datasets["images"], location)
    path = first["profile_path"]
    with open(path) as f:
        stored = json.load(f)
    if damage == "corrupt":
        text = "{not json"
    elif damage == "stale_version":
        text = json.dumps(dict(stored, version=stored["version"] + 1))
    else:
        text = json.dumps(dict(stored, fingerprint="0" * 32))
    with open(path, "w") as f:
        f.write(text)
    # the JAX store reads the same damaged file the same way
    jax_store = jax_planner.ProfileStore(location)
    assert jax_store.load(stored["fingerprint"], stored["schema_hash"]) is None
    with caplog.at_level(logging.WARNING):
        _, second = _read_autotuned(datasets["images"], location)
    assert "pipeline profile" in caplog.text and "planning from" in caplog.text
    assert second["profile"] is None
    assert second["knobs"]["workers"]["source"] == first["knobs"]["workers"]["source"]


def test_profile_store_round_trip_equals_jax(tmp_path):
    for mod in (jax_planner, planner):
        store = mod.ProfileStore(str(tmp_path / "s"))
        path = store.save("f" * 32, "h" * 16, {"knobs": {"workers": 3}})
        assert path == store.path_for("f" * 32, "h" * 16)
        assert store.load("f" * 32, "h" * 16)["knobs"] == {"workers": 3}
    assert planner.ProfileStore(str(tmp_path / "s")).path_for("f" * 32, "h" * 16) == \
        jax_planner.ProfileStore(str(tmp_path / "s")).path_for("f" * 32, "h" * 16)


def test_planner_off_and_pinned_knobs(datasets, tmp_path):
    _, verdict = _read_autotuned(datasets["narrow"], str(tmp_path / "p"))
    assert verdict["knobs"]["workers"]["source"] != "pinned"
    with reader.make_batch_reader(datasets["narrow"], workers_count=3, results_queue_size=5,
                                  autotune=autotune.AutotunePolicy(warmup_s=1e6),
                                  cache_location=str(tmp_path / "p")) as r:
        knobs = r.diagnostics["planner"]["knobs"]
        assert knobs["workers"] == {"value": 3, "source": "pinned",
                                    "why": "explicit workers_count"}
        assert knobs["results_queue"]["source"] == "pinned"
        assert r.diagnostics["workers_count"] == 3
    with reader.make_batch_reader(datasets["narrow"],
                                  autotune=autotune.AutotunePolicy(planner=False,
                                                                   warmup_s=1e6)) as r:
        assert r.planner is None and "planner" not in r.diagnostics
