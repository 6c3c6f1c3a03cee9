"""The port's transform module against the JAX package's, on the CPU.

``transform_cache_info`` must give the JAX package's verdict and reason on
every transform of the JAX suite's own battery (``tests/test_transform_cache.py``):
a cacheable verdict that differs is a wrong cache hit or a lost one.  For a
function that lives outside both packages the signature itself is equal
too.  ``transform_schema`` gives equal schemas, ``row_transform`` equal
outputs, and ``TransformSpec`` the same refusals.
"""

import logging

import numpy as np
import pytest

import petastorm_tpu.transform as jax_transform
from petastorm_tpu import schema as jax_schema
from petastorm_tpu.errors import PetastormTpuError as JaxError
from petastorm_tpu.errors import SchemaError as JaxSchemaError

import petastorm_tpu_torch.transform as torch_transform
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import schema as torch_schema
from petastorm_tpu_torch.errors import PetastormTpuError, SchemaError

import test_transform_cache as battery

_STATE = []


def _pure(cols):
    return dict(cols)


def _noisy(cols):
    return {k: v + np.random.rand() for k, v in cols.items()}


def _timed(cols):
    import time

    return {"x": cols["x"] + int(time.time() > 0)}


def _opaque():
    state = []

    def t(cols):
        state.append(1)
        return dict(cols)
    return t


def _normalizer(mean):
    def t(cols):
        return {"x": cols["x"] - mean}
    return t


def _row_plus(row):
    return {"x": row["x"] + 1, "y": np.full(3, row["x"])}


def _row_noisy(row):
    return {"x": row["x"] + np.random.normal()}


#: name -> (func or None, TransformSpec kwargs)
BATTERY = {
    "pure": (_pure, {}),
    "pure_declared": (_pure, {"deterministic": True}),
    "pure_declared_false": (_pure, {"deterministic": False}),
    "field_selection": (None, {"removed_fields": ["x"]}),
    "selected_fields": (None, {"selected_fields": ["x"]}),
    "noisy": (_noisy, {}),
    "noisy_declared": (_noisy, {"deterministic": True}),
    "clock": (_timed, {}),
    "opaque_closure": (_opaque(), {"deterministic": True}),
    "closure_scale_2": (battery._scaled(2), {}),
    "closure_scale_3": (battery._scaled(3), {}),
    "closure_array": (_normalizer(np.arange(3.0)), {}),
    "global_constant": (battery._global_scaled, {}),
    "global_mutable": (battery._global_stateful, {"deterministic": True}),
    "global_writer": (battery._global_writer, {"deterministic": True}),
    "stochastic_helper": (battery._delegating_transform, {}),
    "slotted_scale": (battery._SlottedScale(2), {"deterministic": True}),
    "slotted_stateful": (battery._SlottedStateful(), {"deterministic": True}),
    "class_routed": (battery._class_routed_transform, {}),
    "ufunc": (np.negative, {}),
    "edit_fields": (_pure, {"edit_fields": [("y", np.float32, (3,), False)],
                            "removed_fields": ["x"]}),
}


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_cache_info_equals_jax(name):
    func, kwargs = BATTERY[name]
    want = jax_transform.transform_cache_info(jax_transform.TransformSpec(func, **kwargs))
    got = torch_transform.transform_cache_info(torch_transform.TransformSpec(func, **kwargs))
    assert got == want
    assert torch_transform.transform_output_cacheable(
        torch_transform.TransformSpec(func, **kwargs)) == want[1:]
    assert torch_transform.transform_signature(
        torch_transform.TransformSpec(func, **kwargs)) == want[0]


def test_the_battery_holds_both_verdicts():
    verdicts = {torch_transform.transform_cache_info(
        torch_transform.TransformSpec(f, **kw))[1] for f, kw in BATTERY.values()}
    assert verdicts == {True, False}
    assert torch_transform.transform_cache_info(None) == jax_transform.transform_cache_info(None)


@pytest.mark.parametrize("row_fn", [_row_plus, _row_noisy])
def test_row_transform_verdict_and_output_equal(row_fn):
    want_spec = jax_transform.TransformSpec(jax_transform.row_transform(row_fn))
    got_spec = torch_transform.TransformSpec(torch_transform.row_transform(row_fn))
    # the wrapper lives in each package's own module, so the signatures
    # differ by its module name; the verdict is the same
    assert (torch_transform.transform_cache_info(got_spec)[1:]
            == jax_transform.transform_cache_info(want_spec)[1:])
    if row_fn is _row_plus:
        cols = {"x": np.arange(5, dtype=np.int64)}
        want, got = want_spec(cols), got_spec(cols)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_row_transform_signature_follows_the_wrapped_function():
    def sig(fn):
        return torch_transform.transform_signature(
            torch_transform.TransformSpec(torch_transform.row_transform(fn)))
    assert sig(_row_plus) != sig(_row_noisy)
    assert sig(_row_plus) == sig(_row_plus)


def _schemas():
    def build(mod, codecs):
        return mod.Schema("T", [
            mod.Field("x", np.int64),
            mod.Field("img", np.uint8, (8, 8, 3), codecs.CompressedImageCodec("png")),
            mod.Field("v", np.float32, (4,), codecs.NdarrayCodec()),
        ])
    from petastorm_tpu import codecs as jax_codecs
    return build(jax_schema, jax_codecs), build(torch_schema, torch_codecs)


def _fields(schema):
    return [(f.name, f.dtype, f.shape, f.nullable, type(f.codec).__name__) for f in schema]


@pytest.mark.parametrize("kwargs", [
    {},
    {"edit_fields": [("y", np.float32, (3,), False)]},
    {"edit_fields": [("x", np.float64, (), True)], "removed_fields": ["v"]},
    {"edit_fields": [("t", np.int64, (), False)], "removed_fields": ["x"]},
    {"selected_fields": ["v", "img"]},
    {"edit_fields": [("y", np.int32, (None,), False)], "selected_fields": ["y", "x"]},
])
def test_transform_schema_equal(kwargs):
    jax_s, torch_s = _schemas()
    want = jax_transform.transform_schema(jax_s, jax_transform.TransformSpec(**kwargs))
    got = torch_transform.transform_schema(torch_s, torch_transform.TransformSpec(**kwargs))
    assert got.name == want.name
    assert _fields(got) == _fields(want)


def test_transform_schema_refusal_matches():
    jax_s, torch_s = _schemas()
    with pytest.raises(JaxSchemaError) as want:
        jax_transform.transform_schema(jax_s, jax_transform.TransformSpec(
            selected_fields=["x", "nope"]))
    with pytest.raises(SchemaError) as got:
        torch_transform.transform_schema(torch_s, torch_transform.TransformSpec(
            selected_fields=["x", "nope"]))
    assert str(got.value) == str(want.value)


def test_spec_call_and_refusal_match():
    cols = {"x": np.arange(4), "y": np.ones(4)}
    kwargs = {"removed_fields": ["y"]}
    want = jax_transform.TransformSpec(_pure, **kwargs)(cols)
    got = torch_transform.TransformSpec(_pure, **kwargs)(cols)
    assert sorted(got) == sorted(want) == ["x"]
    with pytest.raises(JaxError) as want_err:
        jax_transform.TransformSpec(_pure, deterministic="yes")
    with pytest.raises(PetastormTpuError) as got_err:
        torch_transform.TransformSpec(_pure, deterministic="yes")
    assert str(got_err.value) == str(want_err.value)


def test_opaque_refusal_warns_once(caplog):
    spec = torch_transform.TransformSpec(_opaque(), deterministic=True)
    sig, ok, why = torch_transform.transform_cache_info(spec)
    assert not ok and "not foldable" in why
    with caplog.at_level(logging.WARNING, logger="petastorm_tpu_torch.transform"):
        torch_transform.log_output_cache_disabled(spec, why, sig)
        torch_transform.log_output_cache_disabled(spec, why, sig)
    assert len([r for r in caplog.records if "output caching DISABLED" in r.getMessage()]) == 1
