"""Typed tensor schema stored alongside Parquet data.

Counterpart of ``petastorm_tpu/schema.py:42-300``.  ``Field`` and ``Schema``
serialize to the same JSON under the same Parquet key-value metadata key
(``SCHEMA_METADATA_KEY``), so a dataset written by either package opens in
the other.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import OrderedDict, namedtuple
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch import dtypes
from petastorm_tpu_torch.codecs import (Codec, NdarrayCodec, ScalarCodec, ScalarListCodec,
                                        codec_from_json)
from petastorm_tpu_torch.errors import SchemaError

#: Parquet key-value metadata key holding the JSON-serialized Schema.
SCHEMA_METADATA_KEY = b"petastorm-tpu.schema.v1"


@dataclasses.dataclass(frozen=True)
class Field:
    """One named tensor field: dtype, shape (None dims are variable), codec.

    Equality and hash ignore the codec.
    """

    name: str
    dtype: np.dtype
    shape: Tuple[Optional[int], ...] = ()
    codec: Optional[Codec] = None
    nullable: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(self, "shape", tuple(self.shape))
        if self.codec is None:
            default = ScalarCodec() if self.shape == () else NdarrayCodec()
            object.__setattr__(self, "codec", default)

    @property
    def is_fixed_shape(self) -> bool:
        return all(d is not None for d in self.shape)

    def __eq__(self, other):
        if not isinstance(other, Field):
            return NotImplemented
        return (self.name, self.dtype, self.shape, self.nullable) == (
            other.name, other.dtype, other.shape, other.nullable)

    def __hash__(self):
        return hash((self.name, self.dtype, self.shape, self.nullable))

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dtype": "object" if self.dtype.kind == "O" else self.dtype.str,
            "shape": list(self.shape),
            "codec": self.codec.to_json(),
            "nullable": self.nullable,
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Field":
        dtype = np.dtype("object") if obj["dtype"] in ("str", "object") else np.dtype(obj["dtype"])
        return cls(name=obj["name"], dtype=dtype, shape=tuple(obj["shape"]),
                   codec=codec_from_json(obj["codec"]),
                   nullable=bool(obj.get("nullable", False)))


_SelectorT = Union[str, Field, "re.Pattern"]


class Schema:
    """Ordered collection of Fields with views, namedtuple rows and IO forms."""

    def __init__(self, name: str, fields: Sequence[Field]):
        self._name = name
        self._fields: "OrderedDict[str, Field]" = OrderedDict()
        for f in fields:
            if f.name in self._fields:
                raise SchemaError(f"Duplicate field {f.name!r} in schema {name!r}")
            self._fields[f.name] = f
        self._namedtuple = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def fields(self) -> "OrderedDict[str, Field]":
        return self._fields

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __getitem__(self, name: str) -> Field:
        return self._fields[name]

    def __eq__(self, other):
        return isinstance(other, Schema) and list(self) == list(other)

    def __repr__(self):
        return f"Schema({self._name!r}, {list(self._fields.values())!r})"

    def view(self, selectors: Iterable[_SelectorT]) -> "Schema":
        """Sub-schema by Field, exact name or fullmatch regex, in schema order
        (``petastorm_tpu/schema.py:169``)."""
        selected = self.resolve_fields(selectors)
        return Schema(self._name, [f for f in self if f.name in selected])

    def resolve_fields(self, selectors: Iterable[_SelectorT]) -> List[str]:
        """Field names the selectors pick, in selection order
        (``petastorm_tpu/schema.py:178``).  An exact name wins over a regex;
        a regex (``str`` or ``re.Pattern``) fullmatches; a ``Field`` must
        equal the schema's field of its name, or ``SchemaError`` is raised."""
        selected: "OrderedDict[str, None]" = OrderedDict()
        for sel in selectors:
            if isinstance(sel, Field):
                if sel.name not in self._fields or self._fields[sel.name] != sel:
                    raise SchemaError(f"Field {sel.name!r} is not part of schema {self._name!r}")
                selected[sel.name] = None
                continue
            if isinstance(sel, str) and sel in self._fields:
                # exact name wins, so 'a+b' stays selectable and 'a.b' does
                # not also pick 'axb'
                selected[sel] = None
                continue
            pattern = sel.pattern if isinstance(sel, re.Pattern) else sel
            matches = [n for n in self._fields if re.fullmatch(pattern, n)]
            if not matches:
                raise SchemaError(
                    f"Selector {pattern!r} matched no field of schema {self._name!r};"
                    f" fields: {list(self._fields)}")
            for n in matches:
                selected[n] = None
        return list(selected)

    def __getstate__(self):
        # the cached namedtuple type is made at run time and does not pickle
        # (a process-pool worker receives the schema by pickle); it is made
        # again on the other side
        state = self.__dict__.copy()
        state["_namedtuple"] = None
        return state

    def make_namedtuple_type(self):
        """Namedtuple type for one row of this schema (cached per instance)."""
        if self._namedtuple is None:
            self._namedtuple = namedtuple(f"{self._name}_view", list(self._fields))
        return self._namedtuple

    def to_json(self) -> str:
        return json.dumps({"version": 1, "name": self._name,
                           "fields": [f.to_json() for f in self]})

    @classmethod
    def from_json(cls, payload: Union[str, bytes]) -> "Schema":
        obj = json.loads(payload)
        if obj.get("version") != 1:
            raise SchemaError(f"Unsupported schema version {obj.get('version')!r}")
        return cls(obj["name"], [Field.from_json(f) for f in obj["fields"]])

    def as_arrow_schema(self) -> pa.Schema:
        """Arrow storage schema (codec storage types)."""
        return pa.schema([pa.field(f.name, f.codec.storage_type(f), nullable=f.nullable)
                          for f in self])

    @classmethod
    def from_arrow_schema(cls, arrow_schema: pa.Schema, name: str = "inferred",
                          partition_columns: Sequence[str] = ()) -> "Schema":
        """Infer a Schema from plain Parquet storage
        (``petastorm_tpu/schema.py:248-276``): scalar columns become
        ``ScalarCodec`` fields, list-of-scalar columns ``(None,)``
        ``ScalarListCodec`` fields, and partition columns the arrow schema
        lacks object-dtype fields; other nested columns are refused."""
        fields: List[Field] = []
        for af in arrow_schema:
            atype = af.type
            if dtypes.is_list_of_scalars(atype):
                fields.append(Field(af.name, dtypes.arrow_to_numpy(atype.value_type),
                                    shape=(None,), codec=ScalarListCodec(),
                                    nullable=af.nullable))
            elif pa.types.is_nested(atype):
                raise SchemaError(
                    f"Column {af.name!r}: nested arrow type {atype} is not supported;"
                    " select it out with schema_fields")
            else:
                fields.append(Field(af.name, dtypes.arrow_to_numpy(atype), (),
                                    ScalarCodec(), nullable=af.nullable))
        for pcol in partition_columns:
            if pcol not in {f.name for f in fields}:
                fields.append(Field(pcol, np.dtype("object"), (), ScalarCodec(),
                                    nullable=False))
        return cls(name, fields)

    def encode_row(self, row: Dict[str, Any]) -> Dict[str, Any]:
        """Validate and codec-encode one row dict for pyarrow ingestion."""
        unknown = set(row) - set(self._fields)
        if unknown:
            raise SchemaError(f"Unknown fields {sorted(unknown)} for schema {self._name!r}")
        out = {}
        for f in self:
            value = row.get(f.name)
            if value is None:
                if not f.nullable:
                    raise SchemaError(f"Field {f.name!r} is not nullable but got None")
                out[f.name] = None
            else:
                out[f.name] = f.codec.encode(f, value)
        return out


def insert_explicit_nulls(schema: Schema, row: Dict[str, Any]) -> Dict[str, Any]:
    """Add an explicit None for each missing nullable field
    (``petastorm_tpu/schema.py:302``); a missing non-nullable field raises."""
    out = dict(row)
    for f in schema:
        if f.name not in out:
            if not f.nullable:
                raise SchemaError(f"Field {f.name!r} missing and not nullable")
            out[f.name] = None
    return out
