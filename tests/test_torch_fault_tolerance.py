"""The port's failure policy against the JAX package's, on the CPU.

``on_error``/``ErrorPolicy`` with the quarantine ledger
(``petastorm_tpu/errors.py``, ``petastorm_tpu/reader.py:1801-1880``), the
pools' failure contract (``petastorm_tpu/pool.py:61 WorkerError``) and the
in-worker ``MemoryError`` requeue.  The poison is real: a garbage data file,
a JPEG cell cut inside its header (on the host-decode route and on the
hybrid route's entropy decode) and a ``TransformSpec`` that raises on chosen
rows.  Both packages read the same directory on disk; the delivered rows,
the quarantine entries (all six keys), ``skipped_rowgroups``, the cursor and
the stream digest must be equal.  An entry's ``error`` is the last line of
the remote traceback, which names the exception's class by its module: a
codec error of the port reads ``petastorm_tpu_torch.errors.CodecError``
where the JAX package's reads ``petastorm_tpu.errors.CodecError``, so the
comparison maps the one package name onto the other and nothing else.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import errors as jax_errors
from petastorm_tpu import pool as jax_pool
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import transform as jax_transform
from petastorm_tpu.jax import JaxDataLoader

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema
from petastorm_tpu_torch import errors, pool, reader, transform, worker
from petastorm_tpu_torch.cache import InMemoryCache
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.etl.writer import materialize_dataset, write_dataset

SCHEMA = Schema("Faulty", [Field("x", np.int64)])
N_ROWS, RG_ROWS = 40, 4  # 10 rowgroups of 4 rows
PKG = {"jax": (jax_reader, jax_errors, jax_pool, jax_transform),
       "torch": (reader, errors, pool, transform)}


def _write(tmp_path, one_rowgroup_per_file=False, name="ds"):
    url = str(tmp_path / name)
    write_dataset(url, SCHEMA, [{"x": i} for i in range(N_ROWS)], row_group_size_rows=RG_ROWS,
                  rows_per_file=RG_ROWS if one_rowgroup_per_file else None)
    return url


def _garbage(url, index):
    """Overwrite the ``index``-th data file (path order) with garbage bytes."""
    files = sorted(f for f in os.listdir(url) if f.endswith(".parquet"))
    victim = os.path.join(url, files[index])
    size = os.path.getsize(victim)
    with open(victim, "wb") as f:
        f.write(b"\x13" * size)
    return victim


def _rows_without(groups, epochs=1):
    keep = [x for x in range(N_ROWS) if x // RG_ROWS not in groups]
    return keep * epochs


_BAD = {13, 29}  # rowgroups 3 and 7


def _poisoned(columns):
    """A transform that raises on the rows in _BAD."""
    hit = sorted(set(columns["x"].tolist()) & _BAD)
    if hit:
        raise ValueError(f"poisoned rows {hit}")
    return columns


def _spec(pkg, func=_poisoned):
    return PKG[pkg][3].TransformSpec(func)


def _same_names(entries):
    """Quarantine entries with the port's package name read as the JAX one's."""
    return [{k: (v.replace("petastorm_tpu_torch.", "petastorm_tpu.") if k == "error" else v)
             for k, v in e.items()} for e in entries]


def _read(pkg, url, batch=True, **kwargs):
    """Every row a reader delivers, and its diagnostics, quarantine, cursor
    and digest at the end."""
    mod = PKG[pkg][0]
    make = mod.make_batch_reader if batch else mod.make_reader
    with make(url, **kwargs) as r:
        if batch:
            rows = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
        else:
            rows = [int(row.x) for row in r]
        out = {"rows": rows, "skipped": r.diagnostics["skipped_rowgroups"],
               "quarantine": _same_names(sorted(r.quarantined_rowgroups,
                                                key=lambda e: e["ordinal"])),
               "position": r.state_dict()["position"], "digest": r.stream_digest,
               "consumed": r.diagnostics["consumed_items"],
               "requeued": r.diagnostics["requeued_items"]}
    return out


def _parity(url, batch=True, **kwargs):
    """The JAX reader's and the port's reads of ``url``, asserted equal."""
    kw = {k: (v("jax") if callable(v) and k == "transform_spec" else v)
          for k, v in kwargs.items()}
    want = _read("jax", url, batch, **kw)
    kw = {k: (v("torch") if callable(v) and k == "transform_spec" else v)
          for k, v in kwargs.items()}
    got = _read("torch", url, batch, **kw)
    assert got == want
    return got


# -- the policy ---------------------------------------------------------------

@pytest.mark.parametrize("value", ["raise", None, "skip", "ignore", 3,
                                   ("policy", dict(max_skipped_rowgroups=3)),
                                   ("policy", dict(max_skipped_rowgroups=-1)),
                                   ("policy", dict(max_skipped_fraction=1.5)),
                                   ("policy", dict(max_skipped_fraction=-0.1)),
                                   ("policy", dict(max_requeue_attempts=-1)),
                                   ("policy", dict(max_skipped_fraction=0.25,
                                                   max_requeue_attempts=0))])
def test_resolve_error_policy_matches_jax(value):
    def run(errs):
        try:
            v = errs.ErrorPolicy(**value[1]) if isinstance(value, tuple) else value
            policy = errs.resolve_error_policy(v)
        except errs.PetastormTpuError as exc:
            return ("raised", str(exc))
        if policy is None:
            return None
        return dataclass_tuple(policy) + ((policy is v),)

    assert run(errors) == run(jax_errors)


def dataclass_tuple(policy):
    return (policy.max_skipped_rowgroups, policy.max_skipped_fraction,
            policy.max_requeue_attempts)


def test_error_policy_is_frozen_and_defaults_match_jax():
    assert errors.DEFAULT_REQUEUE_ATTEMPTS == jax_errors.DEFAULT_REQUEUE_ATTEMPTS
    assert dataclass_tuple(errors.ErrorPolicy()) == dataclass_tuple(jax_errors.ErrorPolicy())
    with pytest.raises(Exception):
        errors.ErrorPolicy().max_skipped_rowgroups = 3
    assert errors.ErrorPolicy(max_skipped_rowgroups=2) == errors.ErrorPolicy(
        max_skipped_rowgroups=2)


@pytest.mark.parametrize("exc", [errors.CodecError("bad pixels"), ValueError("transform"),
                                 OSError("exhausted retries"), MemoryError(),
                                 pa.ArrowInvalid("not parquet"), KeyError("col"),
                                 errors.CircuitOpenError("open")])
def test_classify_error_matches_jax(exc):
    assert errors.classify_error(exc) == jax_errors.classify_error(exc)


def test_budget_error_carries_diagnostics():
    err = errors.ErrorBudgetExceededError("over", diagnostics={"a": 1})
    assert err.diagnostics == {"a": 1} and str(err) == "over"
    assert errors.ErrorBudgetExceededError("over").diagnostics == {}
    assert issubclass(errors.CircuitOpenError, OSError)
    assert issubclass(errors.EpochNotFinishedError, errors.PetastormTpuError)


# -- on-disk poison under 'skip', both pools ----------------------------------

@pytest.mark.parametrize("pool_type", ["serial", "thread"])
def test_garbage_file_is_quarantined_like_jax(tmp_path, pool_type):
    url = _write(tmp_path, one_rowgroup_per_file=True)
    _garbage(url, 2)
    got = _parity(url, reader_pool_type=pool_type, workers_count=3, shuffle_seed=5,
                  on_error="skip")
    assert sorted(got["rows"]) == _rows_without({2})
    assert got["skipped"] == 1 and got["position"] == 10
    (entry,) = got["quarantine"]
    assert entry["kind"] == "data" and entry["exc_type"] == "ArrowInvalid"
    files = sorted(f for f in os.listdir(url) if f.endswith(".parquet"))
    assert entry["path"] == os.path.join(url, files[2]) and entry["row_group"] == 0
    assert entry["error"].startswith("pyarrow.lib.ArrowInvalid:")


# without a seed the JAX thread pool delivers in completion order
@pytest.mark.parametrize("pool_type,seed", [("serial", None), ("serial", 3), ("thread", 3)])
def test_transform_poison_is_quarantined_like_jax(tmp_path, pool_type, seed):
    url = _write(tmp_path)
    got = _parity(url, reader_pool_type=pool_type, workers_count=2, shuffle_seed=seed,
                  shuffle_row_groups=seed is not None, on_error="skip", transform_spec=_spec)
    assert sorted(got["rows"]) == _rows_without({3, 7})
    assert [e["exc_type"] for e in got["quarantine"]] == ["ValueError", "ValueError"]
    assert got["quarantine"][0]["error"].startswith("ValueError: poisoned rows")
    assert got["position"] == 10


def test_row_reader_two_epochs_skips_in_each_like_jax(tmp_path):
    url = _write(tmp_path)
    got = _parity(url, batch=False, reader_pool_type="thread", workers_count=2,
                  shuffle_seed=1, num_epochs=2, on_error="skip", transform_spec=_spec)
    assert sorted(got["rows"]) == sorted(_rows_without({3, 7}, epochs=2))
    assert got["skipped"] == 4 and got["position"] == 20


def test_skips_above_the_in_flight_window_do_not_wedge(tmp_path):
    """Every rowgroup but one fails: 9 skips through a pool whose window is
    workers_count + results_queue_size = 3 slots."""
    url = _write(tmp_path)

    def most_fail(columns):
        if int(columns["x"][0]) // RG_ROWS != 4:
            raise ValueError("poisoned rowgroup")
        return columns

    kwargs = dict(reader_pool_type="thread", workers_count=2, results_queue_size=1,
                  shuffle_seed=0, on_error="skip")
    out = {}
    # a leaked slot would wedge the read: it runs on a thread with a deadline
    port = threading.Thread(target=lambda: out.update(
        got=_read("torch", url, transform_spec=_spec("torch", most_fail), **kwargs)),
        daemon=True)
    port.start()
    port.join(60)
    assert not port.is_alive(), "the port's pool wedged after its skips"
    got = out["got"]
    assert got == _read("jax", url, transform_spec=_spec("jax", most_fail), **kwargs)
    assert sorted(got["rows"]) == list(range(16, 20))
    assert got["skipped"] == 9 and got["position"] == 10


# -- a corrupt JPEG cell on each route ------------------------------------------

SIDE = 32


def _jpeg_dataset(tmp_path, bad_cells):
    """8 rowgroups of 4 JPEG images (written by the port, then one file
    rewritten through materialize_dataset and pyarrow with the ``bad_cells``
    rows' streams cut inside their headers)."""
    schema = Schema("Jpegs", [Field("idx", np.int64),
                              Field("image", np.uint8, (SIDE, SIDE, 3),
                                    CompressedImageCodec("jpeg", quality=90))])
    rng = np.random.default_rng(0)
    rows = [{"idx": i, "image": rng.integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)}
            for i in range(32)]
    url = str(tmp_path / "jpegs")
    with materialize_dataset(url, schema):
        os.makedirs(url)
        for f in range(2):
            encoded = [schema.encode_row(r) for r in rows[f * 16:(f + 1) * 16]]
            for i, e in enumerate(encoded):
                if f * 16 + i in bad_cells:
                    e["image"] = e["image"][:40]
            table = pa.Table.from_pylist(encoded, schema=schema.as_arrow_schema())
            pq.write_table(table, os.path.join(url, f"part-{f}.parquet"), row_group_size=4)
    return url, rows


@pytest.mark.parametrize("placement", ["host", "device"])
def test_corrupt_jpeg_cell_quarantines_its_rowgroup_like_jax(tmp_path, placement):
    url, _ = _jpeg_dataset(tmp_path, bad_cells={6, 22})
    kwargs = dict(reader_pool_type="thread", workers_count=2, shuffle_seed=2,
                  on_error="skip", decode_placement={"image": placement})
    results = {}
    for pkg in ("jax", "torch"):
        with PKG[pkg][0].make_reader(url, **kwargs) as r:
            idx = [int(i) for b in r.iter_batches() for i in b.columns["idx"]]
            # the JAX thread pool appends skips as they fail, the port in
            # plan order: the JAX ledger is read in ordinal order
            ledger = (r.quarantined_rowgroups if pkg == "torch" else
                      sorted(r.quarantined_rowgroups, key=lambda e: e["ordinal"]))
            results[pkg] = (idx, _same_names(ledger), r.state_dict()["position"],
                            r.stream_digest)
    assert results["torch"] == results["jax"]
    idx, quarantine, position, _ = results["torch"]
    assert sorted(idx) == [i for i in range(32) if i // 4 not in (1, 5)]
    assert [(e["path"][-9:], e["row_group"], e["exc_type"]) for e in quarantine] == [
        ("0.parquet", 1, "CodecError"), ("1.parquet", 1, "CodecError")]
    assert all("cell 2" in e["error"] for e in quarantine)
    assert position == 8


def test_device_route_through_the_loader_skips_like_jax(tmp_path):
    """The hybrid route end to end on the CPU: the entropy decode fails in
    the worker, the rowgroup is quarantined, B2's plain version never sees
    it, and the loader's diagnostics carry the ledger."""
    url, rows = _jpeg_dataset(tmp_path, bad_cells={6})
    kwargs = dict(workers_count=2, shuffle_seed=2, on_error="skip",
                  decode_placement={"image": "device"})
    r = reader.make_reader(url, **kwargs)
    with CudaDataLoader(r, 4, device="cpu") as loader:
        batches = list(loader)
        diag = loader.diagnostics()
    with JaxDataLoader(jax_reader.make_reader(url, **kwargs), 4) as jloader:
        jbatches = list(jloader)
        jdiag = jloader.diagnostics
    got = [int(i) for b in batches for i in b["idx"]]
    assert got == [int(i) for b in jbatches for i in np.asarray(b["idx"])]
    assert sorted(got) == [i for i in range(32) if i // 4 != 1]
    assert diag["skipped_rowgroups"] == jdiag["skipped_rowgroups"] == 1
    assert _same_names(diag["quarantined_rowgroups"]) == _same_names(
        jdiag["quarantined_rowgroups"])
    for b in batches:
        assert b["image"].shape == (4, SIDE, SIDE, 3)


# -- budgets ---------------------------------------------------------------------

@pytest.mark.parametrize("policy,match", [
    (dict(max_skipped_rowgroups=1), "max_skipped_rowgroups"),
    (dict(max_skipped_fraction=0.15), "max_skipped_fraction"),
])
@pytest.mark.parametrize("seed", [None, 4])
def test_budget_exceeded_like_jax(tmp_path, policy, match, seed):
    url = _write(tmp_path)
    out = {}
    for pkg in ("jax", "torch"):
        mod, errs = PKG[pkg][0], PKG[pkg][1]
        r = mod.make_batch_reader(url, reader_pool_type="serial", shuffle_seed=seed,
                                  shuffle_row_groups=seed is not None,
                                  on_error=errs.ErrorPolicy(**policy),
                                  transform_spec=_spec(pkg))
        rows = []
        with pytest.raises(errs.ErrorBudgetExceededError, match=match) as info:
            with r:
                for b in r.iter_batches():
                    rows.extend(int(x) for x in b.columns["x"])
        diag = info.value.diagnostics
        out[pkg] = (rows, str(info.value), diag["skipped_rowgroups"],
                    diag["quarantined_rowgroups"], diag["consumed_items"],
                    diag["stream_digest"], r.state_dict()["position"])
    assert out["torch"] == out["jax"]


def test_budget_within_limits_completes_like_jax(tmp_path):
    url = _write(tmp_path)
    policy = {p: PKG[p][1].ErrorPolicy(max_skipped_rowgroups=2, max_skipped_fraction=0.25)
              for p in PKG}
    want = _read("jax", url, reader_pool_type="serial", shuffle_seed=0,
                 on_error=policy["jax"], transform_spec=_spec("jax"))
    got = _read("torch", url, reader_pool_type="serial", shuffle_seed=0,
                on_error=policy["torch"], transform_spec=_spec("torch"))
    assert got == want and got["skipped"] == 2


@pytest.mark.parametrize("fraction,trips", [(0.2, False), (0.05, True)])
def test_infinite_reader_fraction_uses_the_running_denominator(tmp_path, fraction, trips):
    """num_epochs=None: one rowgroup in ten fails every epoch; the fraction
    divides by the items consumed so far, floored at one epoch."""
    url = _write(tmp_path, one_rowgroup_per_file=True)
    _garbage(url, 1)
    out = {}
    for pkg in ("jax", "torch"):
        mod, errs = PKG[pkg][0], PKG[pkg][1]
        batches = 0
        raised = None
        with mod.make_batch_reader(url, reader_pool_type="serial", shuffle_row_groups=False,
                                   num_epochs=None,
                                   on_error=errs.ErrorPolicy(max_skipped_fraction=fraction)) as r:
            try:
                for _ in r.iter_batches():
                    batches += 1
                    if batches >= 27:  # three epochs of healthy batches
                        break
            except errs.ErrorBudgetExceededError as exc:
                raised = str(exc)
            out[pkg] = (batches, raised, r.diagnostics["skipped_rowgroups"],
                        r.diagnostics["consumed_items"])
    assert out["torch"] == out["jax"]
    assert (out["torch"][1] is not None) == trips
    if not trips:
        assert out["torch"][2] == 3


# -- raise mode ---------------------------------------------------------------------

def test_raise_mode_thread_pool_raises_worker_error_like_jax(tmp_path):
    """The thread pool delivers a worker's failure as the JAX pool does: a
    WorkerError with kind, ordinal, item and exc_type, the remote traceback
    in the message and the worker's exception as the cause (the parent
    commit raised the bare exception here)."""
    url = _write(tmp_path, one_rowgroup_per_file=True)
    _garbage(url, 3)
    out = {}
    for pkg in ("jax", "torch"):
        mod, _, pl, _ = PKG[pkg]
        with pytest.raises(pl.WorkerError, match="magic bytes") as info:
            with mod.make_batch_reader(url, reader_pool_type="thread", workers_count=2,
                                       shuffle_seed=0) as r:
                list(r.iter_batches())
        err = info.value
        item = getattr(err.item, "item", err.item)
        out[pkg] = (err.kind, err.exc_type, err.ordinal, item.row_group.global_index,
                    str(err).splitlines()[0], str(err).splitlines()[-1])
        assert "Traceback" in str(err)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ("data", "ArrowInvalid")
    assert isinstance(err.__cause__, pa.ArrowInvalid)


def test_raise_mode_serial_pool_raises_the_bare_exception_like_jax(tmp_path):
    url = _write(tmp_path)
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="poisoned rows") as info:
            with PKG[pkg][0].make_batch_reader(url, reader_pool_type="serial",
                                               shuffle_row_groups=False,
                                               transform_spec=_spec(pkg)) as r:
                list(r.iter_batches())
        assert type(info.value) is ValueError


def test_on_error_rejects_unknown_value(tmp_path):
    url = _write(tmp_path)
    with pytest.raises(errors.PetastormTpuError, match="on_error"):
        reader.make_batch_reader(url, on_error="ignore")


def test_verify_checksums_reads_a_clean_dataset_like_jax(tmp_path):
    url = _write(tmp_path)
    got = _parity(url, reader_pool_type="serial", shuffle_seed=0, verify_checksums=True,
                  on_error="skip")
    assert sorted(got["rows"]) == list(range(N_ROWS)) and got["skipped"] == 0


def test_verify_checksums_quarantines_a_corrupt_page_like_jax(tmp_path):
    """A flipped byte inside a data page (not the footer): with checksums
    verified the read fails as a data error and is quarantined."""
    url = str(tmp_path / "ds")
    big = Schema("Big", [Field("x", np.int64), Field("v", np.float32, (64,))])
    rng = np.random.default_rng(0)
    write_dataset(url, big, [{"x": i, "v": rng.random(64, dtype=np.float32)}
                             for i in range(N_ROWS)],
                  row_group_size_rows=RG_ROWS, rows_per_file=RG_ROWS)
    victim = os.path.join(url, sorted(f for f in os.listdir(url) if f.endswith(".parquet"))[4])
    md = pq.ParquetFile(victim).metadata
    col = md.row_group(0).column(1)
    offset = (col.dictionary_page_offset or col.data_page_offset) + col.total_compressed_size // 2
    data = bytearray(open(victim, "rb").read())
    data[offset] ^= 0xFF
    open(victim, "wb").write(bytes(data))
    got = _parity(url, reader_pool_type="serial", shuffle_seed=0, verify_checksums=True,
                  on_error="skip")
    assert got["skipped"] == 1 and got["quarantine"][0]["kind"] == "data"
    assert sorted(got["rows"]) == _rows_without({4})


# -- the infra requeue ----------------------------------------------------------------

class _OomOnce:
    """A worker factory whose worker raises MemoryError at the first call
    for item ``trigger`` only."""

    def __init__(self, trigger, unwrap=False):
        self.trigger = trigger
        self.unwrap = unwrap
        self.seen = set()
        self.lock = threading.Lock()

    def __call__(self):
        def fn(item):
            value = getattr(item, "item", item) if self.unwrap else item
            with self.lock:
                first = value == self.trigger and value not in self.seen
                self.seen.add(value)
            if first:
                raise MemoryError("simulated in-worker OOM")
            return value
        return fn


@pytest.mark.parametrize("kind", ["thread", "serial"])
def test_memory_error_is_requeued_like_jax(kind):
    ex = pool.make_executor(kind, 2, 4)
    ex.start(_OomOnce(3))
    got = list(ex.imap(range(6)))
    ex.stop()
    ex.join()
    assert got == list(range(6)) and ex.requeued_items == 1
    # the JAX pool on the same items: one requeue, every item delivered
    jex = (jax_pool.ThreadedExecutor(workers_count=2) if kind == "thread"
           else jax_pool.SerialExecutor())
    with jex:
        jex.start(_OomOnce(3, unwrap=True))
        for i in range(6):
            jex.put(jax_pool.VentilatedItem(i, i))
        want = [jex.get(timeout=5) for _ in range(6)]
        assert jex.diagnostics["requeued_items"] == ex.requeued_items
    assert sorted(want) == got


@pytest.mark.parametrize("kind", ["thread", "serial"])
@pytest.mark.parametrize("stop_on_failure", [True, False])
def test_spent_requeue_budget_is_an_infra_worker_error(kind, stop_on_failure):
    def factory():
        def fn(item):
            if item == 2:
                raise MemoryError("persistent OOM")
            return item
        return fn

    ex = pool.make_executor(kind, 2, 4, stop_on_failure=stop_on_failure,
                            max_requeue_attempts=2)
    ex.start(factory)
    got = []
    try:
        if stop_on_failure:
            with pytest.raises(pool.WorkerError, match="MemoryError") as info:
                for v in ex.imap(range(5), start=10):
                    got.append(v)
            err = info.value
        else:
            got = list(ex.imap(range(5), start=10))
            (err,) = [v for v in got if isinstance(v, pool.WorkerError)]
            assert [v for v in got if not isinstance(v, pool.WorkerError)] == [0, 1, 3, 4]
    finally:
        ex.stop()
        ex.join()
    assert (err.kind, err.ordinal, err.item, err.exc_type) == ("infra", 12, 2, "MemoryError")
    assert isinstance(err.__cause__, MemoryError)
    assert ex.requeued_items == 2


def test_reader_requeues_an_in_worker_memory_error_like_jax(tmp_path):
    url = _write(tmp_path)
    out = {}
    for pkg in ("jax", "torch"):
        seen, lock = set(), threading.Lock()

        def oom_once(columns, seen=seen, lock=lock):
            first = int(columns["x"][0])
            with lock:
                fresh = first == 20 and first not in seen
                seen.add(first)
            if fresh:
                raise MemoryError("simulated in-worker OOM")
            return columns

        out[pkg] = _read(pkg, url, reader_pool_type="thread", workers_count=2,
                         shuffle_seed=0, on_error="skip",
                         transform_spec=_spec(pkg, oom_once))
    assert out["torch"] == out["jax"]
    assert out["torch"]["requeued"] == 1 and out["torch"]["skipped"] == 0
    assert sorted(out["torch"]["rows"]) == list(range(N_ROWS))


def test_reader_quarantines_a_spent_infra_budget_like_jax(tmp_path):
    url = _write(tmp_path)

    def always_oom(columns):
        if int(columns["x"][0]) == 8:
            raise MemoryError("persistent OOM")
        return columns

    out = {}
    for pkg in ("jax", "torch"):
        errs = PKG[pkg][1]
        out[pkg] = _read(pkg, url, reader_pool_type="thread", workers_count=2,
                         shuffle_seed=0,
                         on_error=errs.ErrorPolicy(max_requeue_attempts=1),
                         transform_spec=_spec(pkg, always_oom))
    assert out["torch"] == out["jax"]
    assert [(e["kind"], e["exc_type"]) for e in out["torch"]["quarantine"]] == [
        ("infra", "MemoryError")]
    assert out["torch"]["requeued"] == 1


# -- resume after a skip --------------------------------------------------------------

def test_resume_from_a_cursor_taken_after_a_skip_like_jax(tmp_path):
    url = _write(tmp_path)
    out = {}
    for pkg in ("jax", "torch"):
        mod = PKG[pkg][0]
        kwargs = dict(reader_pool_type="serial", shuffle_seed=9, on_error="skip",
                      transform_spec=_spec(pkg))
        first = []
        with mod.make_batch_reader(url, **kwargs) as r:
            it = r.iter_batches()
            while len(r.quarantined_rowgroups) < 1 or len(first) < 5:
                first.append([int(x) for x in next(it).columns["x"]])
            state = r.state_dict()
        with mod.make_batch_reader(url, resume_from=state, **kwargs) as r:
            rest = [[int(x) for x in b.columns["x"]] for b in r.iter_batches()]
            out[pkg] = (first, state["position"], rest, r.state_dict()["position"],
                        r.stream_digest, r.quarantined_rowgroups)
    assert out["torch"] == out["jax"]
    first, _, rest, position, _, _ = out["torch"]
    assert sorted(x for b in first + rest for x in b) == _rows_without({3, 7})
    assert position == 10


# -- the loader ---------------------------------------------------------------------------

def test_loader_diagnostics_carry_the_ledger_like_jax(tmp_path):
    url = _write(tmp_path)
    kwargs = dict(shuffle_seed=0, workers_count=2, on_error="skip")
    r = reader.make_batch_reader(url, transform_spec=_spec("torch"), **kwargs)
    with CudaDataLoader(r, 4, device="cpu") as loader:
        got = [int(x) for b in loader for x in b["x"]]
        diag = loader.diagnostics()
    jr = jax_reader.make_batch_reader(url, transform_spec=_spec("jax"), **kwargs)
    with JaxDataLoader(jr, 4) as jloader:
        want = [int(x) for b in jloader for x in np.asarray(b["x"])]
        jdiag = jloader.diagnostics
    assert got == want and sorted(got) == _rows_without({3, 7})
    assert diag["skipped_rowgroups"] == jdiag["skipped_rowgroups"] == 2
    # the JAX thread pool appends to its ledger as failures arrive; the
    # port's is in plan order (ROADMAP.md section C)
    assert _same_names(diag["quarantined_rowgroups"]) == _same_names(
        sorted(jdiag["quarantined_rowgroups"], key=lambda e: e["ordinal"]))
    clean = reader.make_batch_reader(url, **kwargs)
    with CudaDataLoader(clean, 4, device="cpu") as loader:
        list(loader)
        assert "skipped_rowgroups" not in loader.diagnostics()


@pytest.mark.parametrize("shuffling_queue_capacity", [0, 16])
def test_loader_raises_the_budget_error_and_ends_its_threads(tmp_path,
                                                            shuffling_queue_capacity):
    url = _write(tmp_path)
    r = reader.make_batch_reader(url, shuffle_seed=0, workers_count=2,
                                 on_error=errors.ErrorPolicy(max_skipped_rowgroups=1),
                                 transform_spec=_spec("torch"))
    loader = CudaDataLoader(r, 4, device="cpu",
                            shuffling_queue_capacity=shuffling_queue_capacity)
    start = time.monotonic()
    with pytest.raises(errors.ErrorBudgetExceededError, match="max_skipped_rowgroups") as info:
        for _ in loader:
            pass
    assert time.monotonic() - start < 30
    assert info.value.diagnostics["skipped_rowgroups"] == 2
    assert len(info.value.diagnostics["quarantined_rowgroups"]) == 2
    for thread in (loader._thread, loader._transfer_thread):
        thread.join(timeout=10)
        assert not thread.is_alive()
    with pytest.raises(errors.ErrorBudgetExceededError):
        next(loader)  # the failure sticks
    loader.stop()


# -- the cache's fill-once lock ----------------------------------------------------------

def test_failed_cache_fill_releases_the_waiting_thread():
    """Two threads read one key; the first fill fails.  The waiter is
    released, fills itself, and fails on its own (as the JAX worker's second
    read would)."""
    w = worker.RowGroupDecoderWorker(SCHEMA, ["x"], cache=InMemoryCache(1 << 20))
    entered, release = threading.Event(), threading.Event()
    calls, errors_seen = [], []

    def fill():
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            entered.set()
            release.wait(5)
        raise ValueError(f"fill {len(calls)} failed")

    def read():
        try:
            w._cached("k", fill)
        except ValueError as exc:
            errors_seen.append(str(exc))

    first = threading.Thread(target=read, name="first")
    first.start()
    entered.wait(5)
    second = threading.Thread(target=read, name="second")
    second.start()
    time.sleep(0.1)
    assert len(calls) == 1  # the second thread waits on the key
    release.set()
    first.join(5)
    second.join(5)
    assert sorted(errors_seen) == ["fill 1 failed", "fill 2 failed"]
    assert not w._filling


def test_memory_cache_reader_quarantines_each_epoch_like_jax(tmp_path):
    url = _write(tmp_path, one_rowgroup_per_file=True)
    _garbage(url, 6)
    got = _parity(url, reader_pool_type="thread", workers_count=3, shuffle_seed=1,
                  num_epochs=2, cache_type="memory", on_error="skip")
    assert got["skipped"] == 2 and got["position"] == 20
    assert sorted(got["rows"]) == sorted(_rows_without({6}, epochs=2))


def test_skips_and_requeues_under_thread_stress_keep_exact_accounting(tmp_path):
    """More workers than cores, a short switch interval, two epochs: every
    healthy row once an epoch, every poisoned rowgroup quarantined once an
    epoch, every infra failure retried once, and the window never leaks
    (a leaked slot would wedge the pool within the first epoch)."""
    import sys

    url = _write(tmp_path)
    calls, lock = {}, threading.Lock()

    def flaky(columns):
        first = int(columns["x"][0])
        if first // RG_ROWS in (2, 5, 8):
            raise ValueError("poisoned rowgroup")
        with lock:
            calls[first] = calls.get(first, 0) + 1
            n = calls[first]
        # the first and third calls of some rowgroups fail as infra: at most
        # two retries an item, within the default budget of 2
        if first % 3 == 0 and n in (1, 3):
            raise MemoryError("simulated in-worker OOM")
        return columns

    out = {}

    def read():
        with reader.make_batch_reader(url, workers_count=16, results_queue_size=1,
                                      shuffle_seed=3, num_epochs=2, on_error="skip",
                                      transform_spec=_spec("torch", flaky)) as r:
            out["rows"] = [int(x) for b in r.iter_batches() for x in b.columns["x"]]
            out["diag"], out["ledger"] = r.diagnostics, r.quarantined_rowgroups

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(60)
        assert not t.is_alive(), "the pool wedged"
    finally:
        sys.setswitchinterval(old)
    rows, diag = out["rows"], out["diag"]
    assert sorted(rows) == sorted(_rows_without({2, 5, 8}, epochs=2))
    assert diag["skipped_rowgroups"] == 6 and diag["consumed_items"] == 20
    assert diag["requeued_items"] >= 1
    assert sorted(e["ordinal"] for e in out["ledger"]) == [e["ordinal"] for e in out["ledger"]]


def test_reader_diagnostics_are_a_subset_of_the_jax_readers(tmp_path):
    """Every key the port's ``Reader.diagnostics`` carries is one of the JAX
    reader's, with the same value after the same read (ROADMAP §C: the
    queue depths, native-plane and telemetry keys are not ported)."""
    url = _write(tmp_path)
    diags = {}
    for pkg in ("jax", "torch"):
        with PKG[pkg][0].make_batch_reader(url, reader_pool_type="serial", shuffle_seed=0,
                                           on_error="skip",
                                           transform_spec=_spec(pkg)) as r:
            list(r.iter_batches())
            diags[pkg] = r.diagnostics
    assert set(diags["torch"]) <= set(diags["jax"])
    assert {"items_per_epoch", "consumed_items", "expected_items", "stream_digest",
            "skipped_rowgroups", "quarantined_rowgroups"} <= set(diags["torch"])
    for key, value in diags["torch"].items():
        want = diags["jax"][key]
        if key == "quarantined_rowgroups":
            value, want = _same_names(value), _same_names(want)
        assert value == want, key
