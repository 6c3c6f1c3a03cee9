"""The port's predicates against the JAX package's, on the CPU.

Every predicate is built in both packages from the same arguments and run
over the same numpy-seeded columns (int, string and object): the masks of
``do_include_vectorized`` and of ``do_include`` row by row must be equal
bit for bit, ``get_fields`` equal, and the refusals the same.
``in_pseudorandom_split`` is held in both of its modes: the native md5
bucketing and ``compat='reference'``'s ``sys.maxsize`` arithmetic.
"""

import numpy as np
import pytest

import petastorm_tpu.predicates as jax_predicates
from petastorm_tpu.errors import PetastormTpuError as JaxError

import petastorm_tpu_torch.predicates as torch_predicates
from petastorm_tpu_torch.errors import PetastormTpuError

N = 257


def _columns(seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-50, 50, N).astype(np.int64)
    strs = np.array([f"s{v}" for v in rng.integers(0, 30, N)])
    objs = np.empty(N, dtype=object)
    for i, v in enumerate(rng.integers(0, 20, N)):
        objs[i] = None if v == 0 else (f"o{v}" if v % 2 else int(v))
    return {"i": ints, "j": rng.integers(0, 10, N).astype(np.int32), "s": strs, "o": objs}


def _is_even(row):
    return row["i"] % 2 == 0


def _between(row, state):
    return state[0] <= row["i"] < state[1]


def _vector_small(cols):
    return np.abs(cols["i"]) < 20


def _vector_state(cols, state):
    return cols["j"] >= state


def _build(mod, case):
    """The predicate ``case`` built from ``mod``'s classes."""
    builders = {
        "in_set_int": lambda: mod.in_set([1, 2, 3, -7, 49], "i"),
        "in_set_str": lambda: mod.in_set({"s1", "s7", "s29", "zz"}, "s"),
        "in_set_obj": lambda: mod.in_set(["o3", 4, 8], "o"),
        "in_intersection": lambda: mod.in_intersection(range(0, 8), ["i", "j"]),
        "in_lambda_row": lambda: mod.in_lambda(["i"], _is_even),
        "in_lambda_row_state": lambda: mod.in_lambda(["i"], _between, state=(-10, 10)),
        "in_lambda_vectorized": lambda: mod.in_lambda(["i"], _vector_small, vectorized=True),
        "in_lambda_vectorized_state": lambda: mod.in_lambda(["j"], _vector_state, state=5,
                                                            vectorized=True),
        "in_negate": lambda: mod.in_negate(mod.in_set(["s1", "s2"], "s")),
        "in_reduce_all": lambda: mod.in_reduce([mod.in_set(range(-20, 20), "i"),
                                                mod.in_lambda(["i"], _is_even)]),
        "in_reduce_any": lambda: mod.in_reduce([mod.in_set(["s3"], "s"),
                                                mod.in_set([1, 2], "j"),
                                                mod.in_negate(mod.in_set([4], "o"))],
                                               np.any),
    }
    for field in ("i", "s", "o"):
        for compat in (None, "reference"):
            for fractions, subset in (([0.5, 0.5], 0), ([0.5, 0.5], 1),
                                      ([0.2, 0.3, 0.5], 1), ([0.7, 0.1], 1)):
                name = f"split_{field}_{compat}_{fractions}_{subset}"
                builders[name] = (lambda f=field, c=compat, fr=fractions, s=subset:
                                  mod.in_pseudorandom_split(fr, s, f, compat=c))
    return builders[case]()


CASES = [
    "in_set_int", "in_set_str", "in_set_obj", "in_intersection", "in_lambda_row",
    "in_lambda_row_state", "in_lambda_vectorized", "in_lambda_vectorized_state",
    "in_negate", "in_reduce_all", "in_reduce_any"]
SPLITS = [f"split_{f}_{c}_{fr}_{s}" for f in ("i", "s", "o") for c in (None, "reference")
          for fr, s in (([0.5, 0.5], 0), ([0.5, 0.5], 1), ([0.2, 0.3, 0.5], 1),
                        ([0.7, 0.1], 1))]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES + SPLITS)
def test_vectorized_masks_equal(case, seed):
    cols = _columns(seed)
    want = _build(jax_predicates, case)
    got = _build(torch_predicates, case)
    assert got.get_fields() == want.get_fields()
    fields = want.get_fields()
    w = np.asarray(want.do_include_vectorized({f: cols[f] for f in fields}))
    g = np.asarray(got.do_include_vectorized({f: cols[f] for f in fields}))
    assert g.dtype == w.dtype == np.bool_
    np.testing.assert_array_equal(g, w)
    assert 0 < w.sum() < N or case.startswith("split_")


@pytest.mark.parametrize("case", CASES + SPLITS)
def test_row_masks_equal(case):
    cols = _columns(2)
    want = _build(jax_predicates, case)
    got = _build(torch_predicates, case)
    fields = want.get_fields()
    for r in range(0, N, 7):
        row = {f: cols[f][r] for f in fields}
        assert got.do_include(row) is want.do_include(row), (case, r)


def test_pseudorandom_splits_partition_the_rows():
    cols = _columns(3)
    for compat in (None, "reference"):
        masks = [torch_predicates.in_pseudorandom_split([0.2, 0.3, 0.5], k, "i",
                                                        compat=compat)
                 .do_include_vectorized(cols) for k in range(3)]
        assert (np.sum(masks, axis=0) == 1).all()
    native = torch_predicates.in_pseudorandom_split([0.5, 0.5], 0, "s")
    reference = torch_predicates.in_pseudorandom_split([0.5, 0.5], 0, "s", compat="reference")
    assert not np.array_equal(native.do_include_vectorized(cols),
                              reference.do_include_vectorized(cols))


@pytest.mark.parametrize("args,kwargs,match", [
    (([0.5, 0.5], 2, "i"), {}, "subset_index"),
    (([0.7, 0.7], 0, "i"), {}, "sum to"),
    (([0.5, 0.5], 0, "i"), {"compat": "petastorm"}, "compat"),
])
def test_split_refusals_match(args, kwargs, match):
    with pytest.raises(JaxError, match=match) as want:
        jax_predicates.in_pseudorandom_split(*args, **kwargs)
    with pytest.raises(PetastormTpuError, match=match) as got:
        torch_predicates.in_pseudorandom_split(*args, **kwargs)
    assert str(got.value) == str(want.value)
