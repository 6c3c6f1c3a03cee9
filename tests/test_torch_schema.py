"""The port's field selection against the JAX package's, on the CPU.

``Schema.resolve_fields`` and ``Schema.view`` must pick the same names in
the same order as ``petastorm_tpu/schema.py:169-200`` for every kind of
selector (exact names, regexes as strings or ``re.Pattern``, ``Field``s),
and refuse the same selectors with the same message.  A ``Field`` selector
whose definition differs from the schema's field of that name is refused:
``make_reader(schema_fields=[that field])`` must not read the stored column
under another dtype.
"""

import re

import numpy as np
import pytest

from petastorm_tpu import schema as jax_schema
from petastorm_tpu.errors import SchemaError as JaxSchemaError
from petastorm_tpu.reader import make_reader as jax_make_reader

from petastorm_tpu_torch import make_reader, write_dataset
from petastorm_tpu_torch import schema as torch_schema
from petastorm_tpu_torch.errors import SchemaError


def _schemas():
    def build(mod):
        return mod.Schema("S", [mod.Field("a", np.int64), mod.Field("a+b", np.float32),
                                mod.Field("axb", np.int32), mod.Field("a.b", np.int16),
                                mod.Field("img", np.uint8, (4, 4, 3)),
                                mod.Field("txt", np.dtype(object), nullable=True)])
    return build(jax_schema), build(torch_schema)


def _selector(mod, kind):
    """Each kind of selector, built with one package's ``Field``."""
    return {
        "names": ["axb", "a"],
        "metachar_names": ["a+b", "a.b"],
        "regex": ["a.*"],
        "regex_and_name": ["img", "a[x+]b"],
        "pattern": [re.compile("a.b")],
        "pattern_and_field": [re.compile("t.t"), mod.Field("img", np.uint8, (4, 4, 3))],
        "fields": [mod.Field("axb", np.int32), mod.Field("a", np.int64)],
        "nullable_field": [mod.Field("txt", np.dtype(object), nullable=True)],
        "duplicates": ["a", "a", re.compile("a"), "img"],
        "empty": [],
        "bad_dtype": [mod.Field("a", np.int32)],
        "bad_shape": [mod.Field("img", np.uint8, (4, 4))],
        "bad_nullable": [mod.Field("a", np.int64, nullable=True)],
        "unknown_field": [mod.Field("zzz", np.int64)],
        "unmatched_regex": ["q.*"],
        "unmatched_pattern": [re.compile("b")],
    }[kind]


KINDS = ["names", "metachar_names", "regex", "regex_and_name", "pattern", "pattern_and_field",
         "fields", "nullable_field", "duplicates", "empty", "bad_dtype", "bad_shape",
         "bad_nullable", "unknown_field", "unmatched_regex", "unmatched_pattern"]


def _outcome(fn):
    try:
        return "ok", fn()
    except (SchemaError, JaxSchemaError) as exc:
        return "SchemaError", str(exc)


@pytest.mark.parametrize("kind", KINDS)
def test_resolve_fields_and_view_equal_jax(kind):
    jax_s, torch_s = _schemas()
    want = _outcome(lambda: jax_s.resolve_fields(_selector(jax_schema, kind)))
    got = _outcome(lambda: torch_s.resolve_fields(_selector(torch_schema, kind)))
    assert got == want
    want_view = _outcome(lambda: [f.to_json() for f in jax_s.view(_selector(jax_schema, kind))])
    got_view = _outcome(lambda: [f.to_json() for f in torch_s.view(_selector(torch_schema, kind))])
    assert got_view == want_view


def test_view_refuses_a_mismatched_field():
    """The repaired fault: the old view took a Field by its name alone."""
    _, torch_s = _schemas()
    with pytest.raises(SchemaError, match="Field 'a' is not part of schema 'S'"):
        torch_s.view([torch_schema.Field("a", np.int32)])
    assert [f.name for f in torch_s.view([torch_schema.Field("a", np.int64)])] == ["a"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("schema_ds") / "ds")
    schema = torch_schema.Schema("S", [torch_schema.Field("a", np.int64),
                                       torch_schema.Field("b", np.float32)])
    write_dataset(path, schema, [{"a": i, "b": float(i)} for i in range(6)])
    return path


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_make_reader_refuses_a_mismatched_field_like_jax(dataset, dtype):
    with pytest.raises(JaxSchemaError) as jax_exc:
        jax_make_reader(dataset, schema_fields=[jax_schema.Field("a", dtype)])
    with pytest.raises(SchemaError) as exc:
        make_reader(dataset, schema_fields=[torch_schema.Field("a", dtype)])
    assert str(exc.value) == str(jax_exc.value)


def test_make_reader_takes_a_matching_field(dataset):
    with make_reader(dataset, reader_pool_type="serial", shuffle_row_groups=False,
                     schema_fields=[torch_schema.Field("a", np.int64)]) as r:
        assert [row.a for row in r] == list(range(6))
        assert list(r.schema.fields) == ["a"]
