"""User transforms applied in the reader's workers.

Counterpart of all of ``petastorm_tpu/transform.py``: ``TransformSpec``
(``func``, ``edit_fields``, ``removed_fields``, ``selected_fields``,
``deterministic``); the bytecode and closure analysis (``_analyze`` and its
helpers) behind ``transform_signature``, ``transform_cache_info``,
``transform_output_cacheable`` and ``log_output_cache_disabled``, which
decides whether a transform's output may be cached; ``transform_schema`` and
``row_transform``.  The analysis is copied as it is: its verdict on a
transform is the JAX package's.

The transform is columnar: ``func`` receives a dict of numpy column arrays
(one entry per field, batch-major) and returns the same.  It runs after the
decode, on every rowgroup that kept a row.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError, SchemaError
from petastorm_tpu_torch.schema import Field, Schema

logger = logging.getLogger(__name__)

#: edit_fields entries: (name, numpy_dtype, shape, nullable)
EditFieldT = Tuple[str, "np.dtype", Tuple[Optional[int], ...], bool]


class TransformSpec:
    """Worker-side columnar transform: ``func(columns) -> columns`` plus the
    schema edits it implies (``edit_fields`` added/retyped, ``removed_fields``
    dropped, ``selected_fields`` kept) - the reader's output schema reflects
    the edits before any data flows (reference transform_spec semantics).

    ``deterministic`` declares whether ``func`` is a pure function of its
    input columns (same batch in -> bit-identical columns out, across calls
    and processes), which is what lets the reader's cache (``cache_type``)
    hold the transform's OUTPUT so warm epochs skip decode AND transform:

    * ``'auto'`` (default) - a conservative pure-bytecode heuristic decides:
      output caching arms only when the compiled function references no
      known-stochastic names (``random``/``shuffle``/``time``/...) and every
      closure cell folds into the cache signature as a stable constant.
    * ``True`` - the user asserts purity; still refused (with a one-time
      warning, never a wrong cache hit) when closure/instance state cannot
      be folded into the signature.
    * ``False`` - the transform re-runs every epoch; its output is never
      cached (augmentation, anything sampling an RNG).
    """
    def __init__(self,
                 func: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
                 edit_fields: Optional[Sequence[EditFieldT]] = None,
                 removed_fields: Optional[Sequence[str]] = None,
                 selected_fields: Optional[Sequence[str]] = None,
                 deterministic: Union[bool, str] = "auto"):
        self.func = func
        self.edit_fields = list(edit_fields or [])
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None
        if deterministic not in (True, False, "auto"):
            raise PetastormTpuError(
                "TransformSpec deterministic must be True, False or 'auto';"
                f" got {deterministic!r}")
        self.deterministic = deterministic

    def __call__(self, columns: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = self.func(columns) if self.func is not None else dict(columns)
        for name in self.removed_fields:
            out.pop(name, None)
        if self.selected_fields is not None:
            out = {k: out[k] for k in self.selected_fields}
        return out


def _hash_code_object(code, update) -> None:
    """Feed a code object's CONTENT (bytecode, names, stable const tokens,
    nested code objects recursively) into ``update``.  repr() of a code
    object embeds its memory address and repr() of a set is
    hash-randomization-ordered - both would make the digest differ between
    interpreters, silently defeating cross-process cache sharing."""
    import types

    update(code.co_code)
    update(repr(code.co_names).encode())
    update(repr(code.co_varnames).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _hash_code_object(const, update)
        elif isinstance(const, frozenset):
            update(("frozenset:"
                    + ",".join(sorted(map(repr, const)))).encode())
        else:
            update(repr(const).encode())


#: closure-cell value types that fold into the signature verbatim (immutable
#: scalars whose repr is stable across interpreters and PYTHONHASHSEEDs)
_SAFE_SCALARS = (type(None), bool, int, float, complex, str, bytes)

#: names whose presence in a transform's bytecode makes the 'auto'
#: determinism heuristic refuse output caching (stochastic / clock sources;
#: false positives only cost a cache, never correctness)
_STOCHASTIC_NAMES = frozenset({
    "random", "default_rng", "RandomState", "Generator", "rand", "randn",
    "randint", "random_sample", "permutation", "shuffle", "choice",
    "normal", "uniform", "standard_normal", "integers", "poisson",
    "binomial", "exponential", "sample", "getrandbits", "urandom",
    "token_bytes", "uuid1", "uuid4", "time", "time_ns", "perf_counter",
    "perf_counter_ns", "monotonic", "monotonic_ns"})


def _constant_token(value, depth: int = 0) -> Optional[str]:
    """Interpreter/PYTHONHASHSEED-stable token for a closure-cell constant,
    or None when the value is not a foldable constant.  Sets/dicts/lists
    (mutable) and arbitrary objects (repr may embed addresses; hashable-by-
    identity objects can mutate without changing their hash) are NOT
    foldable - refusing them is what keeps a folded signature from ever
    serving a wrong cache hit."""
    if depth > 4:
        return None
    if isinstance(value, _SAFE_SCALARS):
        return f"{type(value).__name__}:{value!r}"
    if isinstance(value, tuple):
        parts = [_constant_token(v, depth + 1) for v in value]
        if any(p is None for p in parts):
            return None
        return "tuple:(" + ",".join(parts) + ")"
    if isinstance(value, frozenset):
        parts = [_constant_token(v, depth + 1) for v in value]
        if any(p is None for p in parts):
            return None
        # sorted tokens, never iteration order: frozenset iteration is
        # hash-randomization-ordered across interpreters
        return "frozenset:{" + ",".join(sorted(parts)) + "}"
    if isinstance(value, np.dtype):
        return f"dtype:{value!s}"
    if isinstance(value, np.ndarray) and value.dtype != object:
        # value-hashed at signature time: two jobs closing over different
        # constant arrays (normalization mean/std) get different keys.
        # Mutating a captured array mid-job is out of contract for a
        # deterministic-declared transform.
        import hashlib

        h = hashlib.md5(np.ascontiguousarray(value).tobytes()).hexdigest()
        return f"ndarray:{value.dtype}:{value.shape}:{h[:16]}"
    if isinstance(value, np.generic):
        return f"npscalar:{value.dtype}:{value!r}"
    return None


def _instance_state(obj) -> List[tuple]:
    """Sorted (name, value) pairs of an object's instance state:
    ``__dict__`` PLUS every ``__slots__`` entry in its MRO (a slotted
    callable's config must fold - or refuse - exactly like a dict-backed
    one) PLUS plain data attributes declared on its classes (class-level
    config like ``factor = 2`` is read through ``self.`` just the same)."""
    items = dict(getattr(obj, "__dict__", None) or {})
    for klass in type(obj).__mro__:
        if klass is object:
            continue
        for slot in getattr(klass, "__slots__", ()) or ():
            if isinstance(slot, str) and slot not in ("__dict__",
                                                      "__weakref__"):
                try:
                    items.setdefault(slot, getattr(obj, slot))
                except AttributeError:
                    pass  # never assigned: no state to fold
        for name, value in vars(klass).items():
            if (name.startswith("__") or callable(value)
                    or hasattr(value, "__get__")):
                continue  # methods/descriptors are code, not data
            items.setdefault(name, value)
    return sorted(items.items())


def _fold_state(name: str, value, update, seen: set, names: set,
                depth: int = 0) -> List[str]:
    """Fold one closure cell / instance attribute / referenced global into
    the digest; returns the (possibly nested) names whose values could not
    be folded.  Every reached code object also feeds ``names`` (the
    stochastic-name check must see helpers, not just the top function)."""
    import types

    if depth > 3:
        # a pathological reference graph: refusing keeps the guard honest
        update(f"cell:{name}:<opaque:depth>".encode())
        return [name]
    if isinstance(value, types.ModuleType):
        # module references (np, cv2, ...) fold by name - calls INTO them
        # are covered by the stochastic-name check, like attribute calls
        update(f"cell:{name}:module:{value.__name__}".encode())
        return []
    if callable(value) and getattr(value, "__code__", None) is not None:
        # a captured/referenced python function (row_transform's wrapped fn,
        # module-level helpers): fold its CODE recursively, so editing the
        # inner function's body changes the signature.  Its own closure AND
        # globals fold too.
        update(f"cell:{name}:func".encode())
        if id(value) in seen:
            return []
        seen.add(id(value))
        _hash_code_object(value.__code__, update)
        _collect_names(value.__code__, names)
        opaque = [f"{name}.{n}" for n in
                  _fold_closure(value, update, seen, names, depth + 1)]
        opaque += [f"{name}.{n}" for n in
                   _fold_globals(value, update, seen, names, depth + 1)]
        return opaque
    if isinstance(value, type):
        # a referenced class: folds by qualified name, and its PYTHON
        # method bodies fold too (editing a method changes the cache key)
        # AND feed the stochastic-name scan - a transform routing its RNG
        # call through Jitter().apply() must refuse exactly like an inline
        # np.random call would.  C-implemented classes (np.ndarray, ...)
        # have no inspectable method code and stay name-only.
        update(f"cell:{name}:class:{getattr(value, '__module__', '')}"
               f".{value.__qualname__}".encode())
        if id(value) in seen:
            return []
        seen.add(id(value))
        for klass in value.__mro__:
            if klass is object:
                continue
            for attr in sorted(vars(klass)):
                member = vars(klass)[attr]
                # unwrap static/class methods and properties to their code
                fn = getattr(member, "__func__", None) \
                    or getattr(member, "fget", None) or member
                code = getattr(fn, "__code__", None)
                if code is not None:
                    update(f"cell:{name}.{attr}:method".encode())
                    _hash_code_object(code, update)
                    _collect_names(code, names)
        return []
    if callable(value):
        call_code = getattr(getattr(value, "__call__", None), "__code__",
                            None)
        if call_code is None:
            # C-level callable (np ufunc, builtin): no inspectable state -
            # fold by qualified name
            qual = (f"{getattr(value, '__module__', '')}."
                    f"{getattr(value, '__qualname__', type(value).__qualname__)}")
            update(f"cell:{name}:cfunc:{qual}".encode())
            return []
        # python callable OBJECT: fold its __call__ code + instance state
        # (the same treatment _analyze gives a callable-object spec.func)
        update(f"cell:{name}:callable".encode())
        if id(value) in seen:
            return []
        seen.add(id(value))
        _hash_code_object(call_code, update)
        _collect_names(call_code, names)
        return [f"{name}.{n}" for n in
                _fold_closure(value, update, seen, names, depth + 1)]
    token = _constant_token(value)
    if token is None:
        update(f"cell:{name}:<opaque:{type(value).__name__}>".encode())
        return [name]
    update(f"cell:{name}:{token}".encode())
    return []


def _global_refs(code) -> Tuple[set, set]:
    """(names LOAD_GLOBALed, names STORE/DELETE_GLOBALed) by ``code`` and
    its nested code objects - the precise read/write sets (``co_names``
    alone conflates globals with attribute names)."""
    import dis
    import types

    loads: set = set()
    writes: set = set()
    for ins in dis.get_instructions(code):
        if ins.opname == "LOAD_GLOBAL":
            loads.add(str(ins.argval).removeprefix("NULL + "))
        elif ins.opname in ("STORE_GLOBAL", "DELETE_GLOBAL"):
            writes.add(str(ins.argval))
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            sub_loads, sub_writes = _global_refs(const)
            loads |= sub_loads
            writes |= sub_writes
    return loads, writes


def _fold_globals(func, update, seen: set, names: set,
                  depth: int = 0) -> List[str]:
    """Fold the module globals ``func`` actually reads into the digest (the
    global analog of the closure fold: a transform scaling by a module-level
    ``FACTOR`` must key the cache by its VALUE); returns opaque names.
    Writing any global marks the function opaque outright - a transform
    mutating module state is stateful by construction."""
    code = getattr(func, "__code__", None)
    if code is None:
        return []
    g = getattr(func, "__globals__", None) or {}
    loads, writes = _global_refs(code)
    opaque = [f"<writes global {n}>" for n in sorted(writes)]
    for name in sorted(loads):
        if name not in g:
            # a builtin (len, dict, range, ...): stable by name
            update(f"g:{name}:<builtin>".encode())
            continue
        opaque.extend(_fold_state(f"g:{name}", g[name], update, seen,
                                  names, depth))
    return opaque


def _fold_closure(func, update, seen: set, names: set,
                  depth: int = 0) -> List[str]:
    """Fold ``func``'s closure cells (and, for callable objects, instance
    state incl. ``__slots__`` and class-level data attributes) into the
    digest; returns the names of opaque state."""
    opaque: List[str] = []
    code = getattr(func, "__code__", None)
    cells = getattr(func, "__closure__", None) or ()
    freevars = code.co_freevars if code is not None else ()
    for name, cell in zip(freevars, cells):
        try:
            value = cell.cell_contents
        except ValueError:  # still-empty cell (recursive def mid-build)
            update(f"cell:{name}:<empty>".encode())
            continue
        opaque.extend(_fold_state(name, value, update, seen, names, depth))
    if code is None and callable(func):
        # callable object: its configuring instance state is the closure
        # analog - fold what folds, report the rest as opaque
        call = getattr(func, "__call__", None)
        if call is not None and getattr(call, "__closure__", None):
            opaque.extend(_fold_closure(call, update, seen, names, depth))
        for name, value in _instance_state(func):
            opaque.extend(_fold_state(f"self.{name}", value, update, seen,
                                      names, depth))
    return opaque


def _collect_names(code, out: set) -> None:
    """All names referenced by ``code`` and its nested code objects."""
    import types

    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _collect_names(const, out)


def _analyze(spec: "TransformSpec") -> Tuple[str, List[str], List[str]]:
    """(signature, opaque state names, stochastic names referenced) - the
    one walk both :func:`transform_signature` and
    :func:`transform_output_cacheable` share."""
    import hashlib

    digest = hashlib.md5()
    opaque: List[str] = []
    referenced: set = set()
    func = getattr(spec, "func", None)
    if func is not None:
        # plain function, or a callable object's __call__ (its configuring
        # instance state folds below like closure cells)
        code = getattr(func, "__code__", None) or getattr(
            getattr(func, "__call__", None), "__code__", None)
        if code is not None:
            _hash_code_object(code, digest.update)
            _collect_names(code, referenced)
        seen: set = {id(func)}
        opaque = _fold_closure(func, digest.update, seen, referenced)
        # the GLOBAL analog of the closure fold: module-level constants the
        # function reads key the cache by value, referenced module-level
        # helpers fold their code (AND feed the stochastic-name check - a
        # helper sampling an RNG must refuse like an inline call would),
        # and mutable/written globals mark the spec opaque (a transform
        # reading a module-level list/dict is exactly as stateful as one
        # closing over it)
        target = func if getattr(func, "__code__", None) is not None \
            else getattr(func, "__call__", None)
        if target is not None:
            opaque = opaque + _fold_globals(target, digest.update, seen,
                                            referenced)
        digest.update((f"{getattr(func, '__module__', '')}."
                       f"{getattr(func, '__qualname__', '')}."
                       f"{type(func).__qualname__}").encode())
    digest.update(repr(getattr(spec, "edit_fields", None)).encode())
    digest.update(repr(getattr(spec, "removed_fields", None)).encode())
    digest.update(repr(getattr(spec, "selected_fields", None)).encode())
    stochastic = sorted(referenced & _STOCHASTIC_NAMES)
    return digest.hexdigest()[:12], opaque, stochastic


def transform_signature(spec: Optional["TransformSpec"]) -> str:
    """Short content signature of a transform, for cache keys.

    Two readers sharing one cache directory must never trade entries across
    DIFFERENT transforms, so the cache key carries this digest.  The function half hashes the compiled
    bytecode + constants (recursively through nested code objects, so the
    digest is stable ACROSS interpreters - editing the function body changes
    the key, restarting the process does not) and degrades to the qualified
    name; CLOSURE CELLS and READ MODULE GLOBALS fold in as stable constant
    tokens (a captured or referenced function folds its own code
    recursively, so ``row_transform(f1)`` and ``row_transform(f2)`` sign
    differently and editing a module-level helper changes the key), and
    state that cannot be folded (mutable objects, written globals) is
    marked opaque - such a spec never has its OUTPUT cached
    (:func:`transform_output_cacheable`); the schema-edit half hashes the
    declared field edits.
    """
    if spec is None:
        return "-"
    return _analyze(spec)[0]


def transform_cache_info(spec: Optional["TransformSpec"]) -> Tuple[str, bool, str]:
    """(signature, output_cacheable, reason) from ONE analysis walk - the
    worker's entry point (the walk md5s bytecode and any captured arrays,
    so it must not run twice per reader); :func:`transform_signature` and
    :func:`transform_output_cacheable` are thin views of the same triple."""
    if spec is None:
        return "-", False, "no transform"
    declared = getattr(spec, "deterministic", "auto")
    func = getattr(spec, "func", None)
    sig, opaque, stochastic = _analyze(spec)
    if declared is False:
        return sig, False, "declared deterministic=False"
    if func is None:
        return sig, True, "pure field selection (no func)"
    if opaque:
        # even an explicit deterministic=True cannot overrule this: state
        # the signature cannot capture means two jobs with different state
        # would share one key - the wrong-hit the guard exists to prevent
        return sig, False, ("closure/global/instance state not foldable into"
                            f" the cache signature: {sorted(opaque)}")
    if declared is True:
        return sig, True, "declared deterministic=True"
    code = getattr(func, "__code__", None) or getattr(
        getattr(func, "__call__", None), "__code__", None)
    if code is None:
        return sig, False, "auto: no inspectable bytecode (C callable)"
    if stochastic:
        return sig, False, (f"auto: bytecode references {stochastic}"
                            " (possibly stochastic); declare"
                            " deterministic=True to assert purity")
    return sig, True, "auto: pure-bytecode heuristic"


def transform_output_cacheable(spec: Optional["TransformSpec"]) -> Tuple[bool, str]:
    """May this transform's OUTPUT be served from the warm cache?

    ``(True, why)`` only when a cached post-transform batch is provably
    interchangeable with re-running the transform: the spec declares (or the
    'auto' bytecode heuristic concludes) determinism - the name scan covers
    every captured/referenced helper function, not just the top-level body -
    AND every piece of closure/global/instance state folded into the
    signature.  Anything uncertain refuses - a wrong cache hit is silent
    data corruption, a refused one just re-runs the transform.
    """
    _sig, cacheable, reason = transform_cache_info(spec)
    return cacheable, reason


#: one-time-per-process ledger for output-caching refusal warnings
_CACHE_DISABLED_LOGGED: set = set()


def log_output_cache_disabled(spec: "TransformSpec", reason: str,
                              signature: str) -> None:
    """One-time (per spec signature, per process) notice that post-transform
    output caching is disabled for ``spec``.  Opaque-state refusals WARN
    (the user likely expected the warm win and must restructure the closure
    or accept per-epoch transforms); heuristic refusals log info (the
    conservative default doing its job)."""
    key = (signature, reason)
    if key in _CACHE_DISABLED_LOGGED:
        return
    _CACHE_DISABLED_LOGGED.add(key)
    declared = getattr(spec, "deterministic", "auto")
    if "not foldable" in reason:
        logger.warning(
            "transform output caching DISABLED for %s (deterministic=%r):"
            " %s. The transform re-runs every epoch; warm epochs still skip"
            " decode. Capture only constants (scalars, tuples, arrays) or"
            " pass state through module-level config to re-enable.",
            getattr(spec.func, "__qualname__", spec.func), declared, reason)
    else:
        logger.info(
            "transform output caching not armed for %s (deterministic=%r):"
            " %s", getattr(spec.func, "__qualname__", spec.func), declared,
            reason)


def transform_schema(schema: Schema, spec: TransformSpec) -> Schema:
    """Derive the post-transform schema (reference: transform.py:60-89)."""
    fields = list(schema)
    by_name = {f.name: i for i, f in enumerate(fields)}
    for name, dtype, shape, nullable in spec.edit_fields:
        new = Field(name, np.dtype(dtype), tuple(shape), nullable=nullable)
        if name in by_name:
            fields[by_name[name]] = new
        else:
            by_name[name] = len(fields)
            fields.append(new)
    fields = [f for f in fields if f.name not in set(spec.removed_fields)]
    if spec.selected_fields is not None:
        missing = set(spec.selected_fields) - {f.name for f in fields}
        if missing:
            raise SchemaError(f"selected_fields {sorted(missing)} not in post-transform schema")
        order = {n: i for i, n in enumerate(spec.selected_fields)}
        fields = sorted((f for f in fields if f.name in order), key=lambda f: order[f.name])
    return Schema(schema.name, fields)


def row_transform(fn: Callable[[Dict[str, object]], Dict[str, object]]):
    """Adapt a per-row dict->dict function to the columnar transform contract."""
    def columnar(columns: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        names = list(columns)
        n = len(columns[names[0]]) if names else 0
        rows = [fn({k: columns[k][i] for k in names}) for i in range(n)]
        if not rows:
            return columns
        out: Dict[str, np.ndarray] = {}
        for k in rows[0]:
            vals = [r[k] for r in rows]
            first = np.asarray(vals[0])
            if first.ndim > 0 and all(np.asarray(v).shape == first.shape for v in vals):
                out[k] = np.stack([np.asarray(v) for v in vals])
            else:
                col = np.empty(len(vals), dtype=object)
                for i, v in enumerate(vals):
                    col[i] = v
                out[k] = col if first.ndim > 0 else np.asarray(vals)
        return out
    return columnar
