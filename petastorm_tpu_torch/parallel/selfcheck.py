"""Real multi-process checks of the port's multi-process data plane.

Counterpart of ``petastorm_tpu/parallel/selfcheck.py``: its six checks.
Each launches separate OS processes, one rank each, over a
``torch.distributed`` group on localhost (gloo on the CPU or on one shared
card, NCCL across cards), and verifies in the launching process what the
ranks observed:

* ``run_selfcheck`` (``:998``; workers ``:106-252``, resume ``:872``): sharded
  reading from ``shard_options_from_torch()``; each rank's blocks of the
  global batches, rebuilt into global batches row for row against a
  single-process read of every shard; a masked global mean per step by
  ``all_reduce``; the unequal drain through ``CudaDataLoader.drain()``'s
  default collective (ranks buffer deliberately unequal amounts, so the
  zero-pad path fires and every rank still runs every collective step); and
  an elastic resume of the saved cursors under another process count;
* ``run_distributed_write_check`` (``:847``): ``distributed_write_dataset``
  through its default ``torch.distributed.barrier``, the merged geometry
  sidecars and an exact readback on every rank;
* ``run_context_parallel_check`` (``:321``): sequence-sharded delivery
  (``(Shard(0), Shard(1))`` on a ``("data", "seq")`` mesh spanning the
  ranks), then ring and Ulysses attention (B4) against a float64 full
  attention of the same rows;
* ``run_shuffled_check`` (``:424``; worker ``:372``): seeded shuffled
  sharded reading with stacked delivery (``stack_batches=2``) and a stacked
  drain; every rank's units gathered across the ranks must agree
  (permutation agreement), the masked multiset must be the dataset exactly,
  the order must be the seeded plan's lockstep interleave recomputed in the
  launcher, and the global rank correlation must stay within 0.5;
* ``run_mixed_check`` (``:565``; worker ``:520``): ``'device-mixed'`` JPEG
  decode (B2 on the card) of each rank's shard, the pixels gathered across
  the ranks identical on every rank and within the hybrid tolerance (max 6,
  mean below 1) of the launcher's host decode, the pad region zero;
* ``run_mesh2d_check`` (``:752``; worker ``:656``): dp x tp delivery on a
  ``("data", "model")`` mesh whose data dimension crosses the processes
  (ids over ``data``, tokens' sequence over ``model``), then a loss whose
  tp-sharded weight is summed over ``model`` and whose result is summed over
  both dimensions, against a numpy reference and equal on every rank.

A JAX process owns several devices; a port rank owns one card (ROADMAP.md
§C, "Multi-process").  The shuffled and mixed checks shard the reader by
process in both packages and deliver each process its block of the global
batch, so a JAX process's ``devices_per_process`` devices map to the one
card of its rank and the data checks are unchanged.  The 2-D check's
``model`` dimension lives inside a JAX process; the port launches
``num_processes * devices_per_process`` ranks on a ``(num_processes,
devices_per_process)`` mesh, so its ``data`` dimension crosses groups of
ranks as the JAX one crosses processes.

Each takes ``device=`` (``'cuda'`` by default: every rank on the card of
its local rank modulo the card count, and a RuntimeError without a card;
``'cpu'`` on the host) and ``backend=`` (by default NCCL when the ranks have
distinct cards, gloo when they share one or run on the host).  The workers
run ``python -m petastorm_tpu_torch.parallel.selfcheck --worker ...``, one a
rank through :func:`petastorm_tpu_torch.parallel.launch.run_ranks`, so they
import no test module.  A report is ``{"ok": bool, "failures": [...],
...}``; a worker that fails or outlives ``timeout`` is a failure.  From a
shell::

    python -m petastorm_tpu_torch.parallel.selfcheck --phase pipeline --num-processes 2
    python -m petastorm_tpu_torch.parallel.selfcheck --phase cp --device cpu
    python -m petastorm_tpu_torch.parallel.selfcheck --phase shuffled|mixed|mesh2d
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

MASK_FIELD = "mask"
_ID = "id"
_VALUE = "value"
_VALUE_DIM = 4
#: head count of the context-parallel check (Ulysses runs when it divides
#: the rank count)
_CP_HEADS = 4
#: the mixed check's two JPEG geometries and the delivered target
_MIXED_GEOMS = ((16, 24), (24, 16))
_MIXED_TARGET = (24, 24, 3)
#: the 2-D check's vocabulary and hidden width
_M2D_VOCAB = 32
_M2D_HIDDEN = 16


def _value_for_ids(ids):
    ids = np.asarray(ids, dtype=np.float32)
    return np.stack([ids * 0.5, ids - 3.0, ids % 7.0, ids * 0.25], axis=-1).astype(np.float32)


# -- worker side -------------------------------------------------------------------

def _worker_device(args):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _all_gather_ints(values) -> List[List[int]]:
    """Every rank's list of ints (each rank gives as many)."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import group_device

    dev = group_device(None)
    mine = torch.tensor(values, dtype=torch.int64, device=dev)
    out = torch.empty(dist.get_world_size() * len(values), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(out, mine)
    return out.reshape(dist.get_world_size(), len(values)).tolist()


def _worker_pipeline(args, device) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader
    from petastorm_tpu_torch.parallel.mesh import all_reduce_, shard_options_from_torch
    from petastorm_tpu_torch.reader import make_reader

    pid = dist.get_rank()
    mesh = init_device_mesh("cuda" if args.backend == "nccl" else "cpu",
                            (dist.get_world_size(),), mesh_dim_names=("data",))
    cur, count = shard_options_from_torch()
    local_rows = args.global_batch // count
    # deliberately asymmetric buffering: the higher rank holds a deeper
    # in-flight window, so at the drain the ranks hold unequal counts and the
    # pad path must fire; one worker pins delivery to plan order
    reader = make_reader(args.dataset, cur_shard=cur, shard_count=count,
                         shuffle_row_groups=False, num_epochs=1, workers_count=1,
                         results_queue_size=2 + 8 * pid)
    batches: List[Dict] = []
    means: List[float] = []

    def step(batch, kind):
        value, mask = batch[_VALUE], batch[MASK_FIELD]
        # the masked global mean: every rank runs it on every step
        sums = torch.stack([(value.sum(dim=1) * mask).sum(), mask.sum()]).double()
        all_reduce_(sums, None)
        means.append(float(sums[0] / sums[1].clamp_min(1.0)))
        ids = batch[_ID].cpu().numpy().astype(int)
        batches.append({"kind": kind, "ids": ids.tolist(),
                        "mask": mask.cpu().numpy().tolist(),
                        "valid_rows": int(batch.get(VALID_ROWS, -1)),
                        "values_match": bool(np.allclose(value.cpu().numpy(),
                                                         _value_for_ids(ids))),
                        "device": str(value.device)})

    with CudaDataLoader(reader, batch_size=args.global_batch, device=device, mesh=mesh,
                        shardings={_ID: (Shard(0),), _VALUE: (Shard(0),)}, drop_last=False,
                        prefetch=2 + 6 * pid, valid_mask_field=MASK_FIELD) as loader:
        step(next(iter(loader)), "consumed")
        time.sleep(args.settle)  # let every rank's pipeline buffer to capacity
        drained_real = pad_count = 0
        for batch in loader.drain():  # the default collective: all_gather_counts=None
            if batch.get(VALID_ROWS, local_rows) == 0:
                pad_count += 1
                step(batch, "drain_pad")
            else:
                drained_real += 1
                step(batch, "drain_real")
        state = loader.state_dict()["reader"]
    gathered = _all_gather_ints([drained_real, drained_real + pad_count, len(means)])
    with open(os.path.join(args.out, f"state_{pid}.pkl"), "wb") as f:
        pickle.dump(state, f)
    report = {"process_id": pid, "process_count": count, "local_rows": local_rows,
              "cur_shard": cur, "shard_count": count, "drained_real": drained_real,
              "pad_count": pad_count, "real_all": [g[0] for g in gathered],
              "drain_steps_all": [g[1] for g in gathered],
              "steps_all": [g[2] for g in gathered], "means": means, "batches": batches,
              "ordinal_exact": bool(state.get("ordinal_exact"))}
    with open(os.path.join(args.out, f"worker_{pid}.json"), "w") as f:
        json.dump(report, f)


def _worker_resume(args, device) -> None:
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import shard_options_from_torch
    from petastorm_tpu_torch.reader import elastic_resume, make_reader

    with open(args.resume_states, "rb") as f:
        token = elastic_resume(pickle.load(f))
    cur, count = shard_options_from_torch()
    ids: List[int] = []
    with make_reader(args.dataset, cur_shard=cur, shard_count=count, shuffle_row_groups=False,
                     num_epochs=1, workers_count=1, resume_from=token) as reader:
        for cb in reader.iter_batches():
            ids.extend(np.asarray(cb.columns[_ID]).astype(int).tolist())
    with open(os.path.join(args.out, f"resume_{dist.get_rank()}.json"), "w") as f:
        json.dump({"process_id": dist.get_rank(), "process_count": count, "ids": ids}, f)


def _worker_write(args, device) -> None:
    import torch.distributed as dist

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.parallel.write import distributed_write_dataset
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.schema import Field, Schema

    pid, count = dist.get_rank(), dist.get_world_size()
    schema = Schema("MpWrite", [
        Field(_ID, np.int32),
        Field("image", np.uint8, (None, None, 3), CompressedImageCodec("png")),
    ])
    total = args.global_batch * 8
    rng = np.random.default_rng(7)
    rows = [{_ID: np.int32(i),
             "image": rng.integers(0, 255, ((16, 24) if i % 2 else (24, 16)) + (3,),
                                   dtype=np.uint8)}
            for i in range(total)]
    url = os.path.join(args.out, "mp_written_ds")
    # the default coordination: rank, world size and the barrier from the group
    files = distributed_write_dataset(url, schema, rows[pid::count], row_group_size_rows=4)
    ids: List[int] = []
    with make_batch_reader(url, num_epochs=1, workers_count=1) as reader:
        declared = reader.declared_geometries
        for cb in reader.iter_batches():
            ids.extend(np.asarray(cb.columns[_ID]).astype(int).tolist())
    if sorted(ids) != list(range(total)):
        raise AssertionError(f"read back {len(ids)} rows, {len(set(ids))} distinct, of {total}")
    if sorted(declared["image"]) != [(16, 24, 3), (24, 16, 3)]:
        raise AssertionError(f"declared geometries {declared}")
    with open(os.path.join(args.out, f"write_{pid}.json"), "w") as f:
        json.dump({"process_id": pid, "files": len(files), "rows_read": len(ids),
                   "geometries": sorted(declared["image"])}, f)


def _worker_cp(args, device) -> None:
    """Sequence-sharded delivery (every rank reads every row and keeps its
    range of the sequence), then ring and Ulysses attention over a mesh
    spanning the ranks, against a float64 full attention of the rows."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.ulysses import ulysses_attention
    from petastorm_tpu_torch.parallel.mesh import transport_name
    from petastorm_tpu_torch.reader import make_reader

    pid, n = dist.get_rank(), dist.get_world_size()
    mesh = init_device_mesh("cuda" if args.backend == "nccl" else "cpu", (1, n),
                            mesh_dim_names=("data", "seq"))
    reader = make_reader(args.dataset, shuffle_row_groups=False, num_epochs=1, workers_count=1)
    with CudaDataLoader(reader, batch_size=args.global_batch, device=device, mesh=mesh,
                        shardings={_ID: (Shard(0), Replicate()),
                                   "x": (Shard(0), Shard(1))}) as loader:
        batch = next(iter(loader))
    x = batch["x"]  # (B, S / n, D) on this rank's device
    b, s_local, d = x.shape
    h, dh = _CP_HEADS, d // _CP_HEADS
    qkv = x.reshape(b, s_local, h, dh).transpose(1, 2).contiguous()
    with make_reader(args.dataset, shuffle_row_groups=False, num_epochs=1,
                     workers_count=1) as full_reader:
        rows = {int(r.id): r.x for r in full_reader}
    full = np.stack([rows[i] for i in batch[_ID].cpu().numpy().astype(int)]).astype(np.float64)
    s = full.shape[1]
    q = full.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    scores = np.einsum("bhqd,bhkd->bhqk", q, q) / np.sqrt(dh)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    w = np.exp(scores - scores.max(axis=-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", w / w.sum(axis=-1, keepdims=True), q)
    ref = ref[:, :, pid * s_local:(pid + 1) * s_local]
    out = {"process_id": pid, "process_count": n, "shape": [b, s, d],
           "device": str(x.device), "transport": transport_name(mesh.get_group(1), x.device)}
    strategies = [("ring", ring_attention)] + ([("uly", ulysses_attention)] if h % n == 0 else [])
    for name, fn in strategies:
        got = fn(qkv, qkv, qkv, mesh, causal=True)
        err = float(np.max(np.abs(got.double().cpu().numpy() - ref)))
        if err >= 2e-4:
            raise AssertionError(f"{name} attention diverged: max err {err}")
        out[f"err_{name}"] = err
    with open(os.path.join(args.out, f"cp_{pid}.json"), "w") as f:
        json.dump(out, f)


def _gather_rows(t, dim: int = 0):
    """Every rank's block of ``t`` concatenated along ``dim``, on the host:
    the port's counterpart of the JAX checks' replicating ``jit`` (a real
    cross-process all-gather)."""
    from petastorm_tpu_torch.parallel.mesh import gather_blocks

    return gather_blocks(t.movedim(dim, 0)).movedim(0, dim)


def _worker_shuffled(args, device) -> None:
    """Seeded shuffled sharded reading with stacked delivery and a stacked
    drain (``petastorm_tpu/parallel/selfcheck.py:372``): every rank reads its
    shard with the same seeded rowgroup permutation, units arrive as
    ``(K, local, ...)`` stacks, and each unit's ids and mask are gathered
    over the ranks so the launcher can hold every rank to one global order."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.parallel.mesh import all_reduce_, shard_options_from_torch
    from petastorm_tpu_torch.reader import make_reader

    pid = dist.get_rank()
    mesh = init_device_mesh("cuda" if args.backend == "nccl" else "cpu",
                            (dist.get_world_size(),), mesh_dim_names=("data",))
    cur, count = shard_options_from_torch()
    reader = make_reader(args.dataset, cur_shard=cur, shard_count=count,
                         shuffle_row_groups=True, shuffle_seed=args.seed, num_epochs=1,
                         workers_count=1)
    units: List[Dict] = []
    means: List[float] = []

    def record(u):
        # the collective runs on every unit, drain pads included
        value, mask = u[_VALUE], u[MASK_FIELD]
        sums = torch.stack([(value.sum(dim=-1) * mask).sum(), mask.sum()]).double()
        all_reduce_(sums, None)
        means.append(float(sums[0] / sums[1].clamp_min(1.0)))
        units.append({"ids": _gather_rows(u[_ID], 1).long().tolist(),
                      "mask": _gather_rows(mask, 1).tolist(),
                      "device": str(value.device)})

    with CudaDataLoader(reader, batch_size=args.global_batch, device=device, mesh=mesh,
                        stack_batches=2, drop_last=False,
                        shardings={_ID: (Shard(0),), _VALUE: (Shard(0),)},
                        valid_mask_field=MASK_FIELD) as loader:
        record(next(iter(loader)))
        for u in loader.drain():  # the stacked drain over the default collective
            record(u)
    with open(os.path.join(args.out, f"shuffled_{pid}.json"), "w") as f:
        json.dump({"process_id": pid, "process_count": count, "units": units,
                   "means": means}, f)


def _worker_mixed(args, device) -> None:
    """``'device-mixed'`` JPEG decode over a mesh spanning the ranks
    (``petastorm_tpu/parallel/selfcheck.py:520``): each rank entropy-decodes
    and bucket-decodes (B2) only its shard's rows, and the gathered pixels
    show what every rank decoded."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from petastorm_tpu_torch.cuda.loader import CudaDataLoader
    from petastorm_tpu_torch.ops import jpeg
    from petastorm_tpu_torch.parallel.mesh import shard_options_from_torch
    from petastorm_tpu_torch.reader import make_batch_reader

    pid = dist.get_rank()
    mesh = init_device_mesh("cuda" if args.backend == "nccl" else "cpu",
                            (dist.get_world_size(),), mesh_dim_names=("data",))
    cur, count = shard_options_from_torch()
    reader = make_batch_reader(args.dataset, cur_shard=cur, shard_count=count,
                               shuffle_row_groups=False, num_epochs=1, workers_count=1,
                               decode_placement={"image": "device-mixed"})
    got: Dict[int, np.ndarray] = {}
    for suffix in ("", "_tiled", "_general"):
        setattr(jpeg.jpeg_decode_kernel, "launches" + suffix, 0)
    with CudaDataLoader(reader, batch_size=args.global_batch, device=device, mesh=mesh,
                        fields=[_ID, "image"], pad_shapes={"image": _MIXED_TARGET},
                        shardings={_ID: (Shard(0),), "image": (Shard(0),)}) as loader:
        for b in loader:
            image_device = str(b["image"].device)
            ids = _gather_rows(b[_ID]).long().numpy()
            imgs = _gather_rows(b["image"]).numpy()
            for k, i in enumerate(ids):
                got[int(i)] = imgs[k]
        diag = loader.diagnostics()
    order = sorted(got)
    np.save(os.path.join(args.out, f"mixed_{pid}.npy"), np.stack([got[i] for i in order]))
    with open(os.path.join(args.out, f"mixed_{pid}.json"), "w") as f:
        json.dump({"process_id": pid, "process_count": count, "ids": order,
                   "geometries": diag.get("mixed_decode_geometries", {}),
                   "declared": diag.get("declared_geometries", {}),
                   "b2_launches": jpeg.jpeg_decode_kernel.launches_tiled,
                   "b2_general_launches": jpeg.jpeg_decode_kernel.launches_general,
                   "device": image_device}, f, default=str)


def _worker_mesh2d(args, device) -> None:
    """dp x tp delivery on a ``("data", "model")`` mesh
    (``petastorm_tpu/parallel/selfcheck.py:656``): ids over ``data``, the
    tokens' sequence over ``model``; then a loss with a tp-sharded weight,
    its column sums summed over ``model`` and the result over both
    dimensions, against a numpy reference."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from petastorm_tpu_torch.cuda.loader import make_cuda_loader
    from petastorm_tpu_torch.parallel.mesh import all_reduce_, mesh_coordinate
    from petastorm_tpu_torch.reader import make_reader

    pid, world = dist.get_rank(), dist.get_world_size()
    tp = args.devices_per_process
    dp = world // tp
    mesh = init_device_mesh("cuda" if args.backend == "nccl" else "cpu", (dp, tp),
                            mesh_dim_names=("data", "model"))
    d, m = mesh_coordinate(mesh)
    with make_cuda_loader(args.dataset, args.global_batch, mesh=mesh,
                          shardings={_ID: (Shard(0), Replicate()),
                                     "tokens": (Shard(0), Shard(1))},
                          reader_factory=make_reader, shuffle_row_groups=False, num_epochs=1,
                          workers_count=1, device=device) as loader:
        batch = next(iter(loader))
    ids, tokens = batch[_ID], batch["tokens"]
    rows, s_local = tokens.shape
    lo, hi = d * rows, (d + 1) * rows
    s0 = m * s_local
    got_ids = ids.cpu().numpy().astype(int)
    if got_ids.tolist() != list(range(lo, hi)):
        raise AssertionError(f"rank {pid} (data {d}) holds rows {got_ids.tolist()},"
                             f" not its block [{lo}, {hi}) of the global batch")
    expected = (got_ids[:, None] * 7 + np.arange(s0, s0 + s_local)[None, :]) % _M2D_VOCAB
    if not np.array_equal(tokens.cpu().numpy(), expected):
        raise AssertionError("2-D delivery scrambled rows or the sequence range")
    rng = np.random.default_rng(5)
    emb_np = rng.standard_normal((_M2D_VOCAB, _M2D_HIDDEN)).astype(np.float32)
    w_np = rng.standard_normal((_M2D_HIDDEN, _M2D_HIDDEN)).astype(np.float32)
    k = _M2D_HIDDEN // tp
    emb = torch.from_numpy(emb_np).to(device)
    w_local = torch.from_numpy(np.ascontiguousarray(w_np[:, m * k:(m + 1) * k])).to(device)
    # sum over (b, s, k) of e[t_bs] . W[:, k] = sum over (b, s) of e[t_bs] . W.sum(1):
    # the tp-sharded weight's column sums summed over "model", then this
    # rank's (rows, sequence range) block, summed over both dimensions
    w_sum = w_local.sum(dim=1)
    all_reduce_(w_sum, mesh.get_group("model"))
    total = (emb[tokens.long()] @ w_sum).sum().reshape(1)
    all_reduce_(total, None)
    global_batch, seq = rows * dp, s_local * tp
    loss = float(total[0]) / (global_batch * seq * _M2D_HIDDEN)
    all_tokens = (np.arange(global_batch)[:, None] * 7 + np.arange(seq)[None, :]) % _M2D_VOCAB
    ref = float(np.mean(np.einsum("bsh,hk->bsk", emb_np[all_tokens], w_np)))
    err = abs(loss - ref) / max(abs(ref), 1e-9)
    if err >= 1e-5:
        raise AssertionError(f"dp x tp collective diverged: {loss} vs {ref}")
    with open(os.path.join(args.out, f"mesh2d_{pid}.json"), "w") as f:
        json.dump({"process_id": pid, "loss": loss, "ref": ref, "rel_err": err,
                   "coordinate": [d, m], "device": str(tokens.device),
                   "mesh": {"data": dp, "model": tp}}, f)


_PHASES = {"pipeline": _worker_pipeline, "resume": _worker_resume, "write": _worker_write,
           "cp": _worker_cp, "shuffled": _worker_shuffled, "mixed": _worker_mixed,
           "mesh2d": _worker_mesh2d}


def _worker_main(args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(min(torch.get_num_threads(), 2))
    device = _worker_device(args)
    dist.init_process_group(args.backend, init_method="env://")
    try:
        _PHASES[args.phase](args, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# -- launcher side -----------------------------------------------------------------

def _backend(device: str, num_processes: int, backend: Optional[str]) -> str:
    """``backend``, or by default NCCL when every rank has a card of its own
    and gloo when ranks share one or run on the host."""
    import torch

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA GPU is available;"
                           " pass device='cpu' to run on the host")
    if backend is not None:
        return backend
    return "nccl" if device == "cuda" and num_processes <= torch.cuda.device_count() else "gloo"


def _launch(phase: str, num_processes: int, dataset: str, out: str, timeout: float,
            logs: List[str], device: str, backend: Optional[str],
            extra: Optional[List[str]] = None) -> Optional[str]:
    """Run one worker a rank; an error string, or None."""
    from petastorm_tpu_torch.parallel.launch import log_path, run_ranks

    prefix = os.path.join(out, phase)
    logs.extend(log_path(prefix, r) for r in range(num_processes))
    cmd = [sys.executable, "-m", "petastorm_tpu_torch.parallel.selfcheck", "--worker",
           "--phase", phase, "--dataset", dataset, "--out", out, "--device", device,
           "--backend", _backend(device, num_processes, backend)] + (extra or [])
    return run_ranks(cmd, num_processes, timeout, prefix, env={"OMP_NUM_THREADS": "1"})


def _report(workdir: str, **fields) -> Dict:
    return {"ok": False, "failures": [], "workdir": workdir, **fields}


def _read(workdir: str, prefix: str, n: int) -> List[Dict]:
    out = []
    for pid in range(n):
        with open(os.path.join(workdir, f"{prefix}_{pid}.json")) as f:
            out.append(json.load(f))
    return out


def run_selfcheck(num_processes: int = 2, global_batch: int = 8, n_batches: int = 28,
                  resume_processes: Optional[int] = 3, settle: float = 1.5,
                  timeout: float = 240.0, workdir: Optional[str] = None,
                  device: str = "cuda", backend: Optional[str] = None) -> Dict:
    """The multi-process data-plane check; returns a report (``ok``,
    ``failures``, and what the ranks drained, padded and resumed)."""
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.schema import Field, Schema

    if global_batch % num_processes:
        raise ValueError("global_batch must divide evenly over the processes")
    chosen = _backend(device, num_processes, backend)  # the resume may take another
    local_rows = global_batch // num_processes
    total_rows = n_batches * global_batch
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_selfcheck_")
    os.makedirs(workdir, exist_ok=True)
    dataset = os.path.join(workdir, f"ds_gb{global_batch}_nb{n_batches}_np{num_processes}")
    if not os.path.exists(dataset):
        write_dataset(dataset, Schema("SelfCheck", [Field(_ID, np.int32),
                                                    Field(_VALUE, np.float32, (_VALUE_DIM,))]),
                      [{_ID: np.int32(i), _VALUE: _value_for_ids([i])[0]}
                       for i in range(total_rows)],
                      row_group_size_rows=local_rows)
    report = _report(workdir, num_processes=num_processes, global_batch=global_batch,
                     n_batches=n_batches, device=device, backend=chosen, notes=[])
    failures, logs = report["failures"], []
    report["logs"] = logs
    # the drained counts' inequality comes from the asymmetric buffering and
    # a settle sleep; a contended machine can even them out, so one retry
    # with a longer settle, and `pad_exercised` says whether the pads fired
    workers: List[Dict] = []
    for attempt in range(2):
        error = _launch("pipeline", num_processes, dataset, workdir, timeout, logs, device,
                        backend, ["--global-batch", str(global_batch),
                                  "--settle", str(settle * 2 ** attempt)])
        if error:
            failures.append(error)
            return report
        workers = _read(workdir, "worker", num_processes)
        if len(set(workers[0]["real_all"])) > 1:
            break
        report["notes"].append(f"attempt {attempt + 1}: ranks drained equal counts"
                               f" {workers[0]['real_all']}")
    report["pad_exercised"] = len(set(workers[0]["real_all"])) > 1

    def shard_ids(shard: int, count: int) -> List[int]:
        out: List[int] = []
        with make_reader(dataset, cur_shard=shard, shard_count=count, shuffle_row_groups=False,
                         num_epochs=1, workers_count=1) as reader:
            for cb in reader.iter_batches():
                out.extend(np.asarray(cb.columns[_ID]).astype(int).tolist())
        return out

    expected = [shard_ids(p, num_processes) for p in range(num_processes)]
    consumed: List[int] = []
    real_batches = []
    for w in workers:
        pid = w["process_id"]
        real = [b for b in w["batches"] if b["kind"] != "drain_pad"]
        real_batches.append(real)
        for b in w["batches"]:
            if b["kind"] == "drain_pad":
                if any(v != 0.0 for v in b["mask"]) or b["valid_rows"] != 0:
                    failures.append(f"rank {pid}: a drain pad with mask {b['mask']} and"
                                    f" valid rows {b['valid_rows']}")
            elif b["mask"] != [1.0] * local_rows or not b["values_match"]:
                failures.append(f"rank {pid}: a real batch with mask {b['mask']} or values"
                                " not f(id)")
        consumed.extend(expected[pid][:len(real) * local_rows])
        if not w["ordinal_exact"]:
            failures.append(f"rank {pid}: the drained cursor is not ordinal-exact")
        if len(set(w["drain_steps_all"])) != 1 or len(set(w["steps_all"])) != 1:
            failures.append(f"rank {pid}: unaligned steps {w['drain_steps_all']}"
                            f" {w['steps_all']}")
        if any(not np.isfinite(m) for m in w["means"]):
            failures.append(f"rank {pid}: a non-finite collective result")
    # global batches rebuilt from every rank's blocks, row for row
    steps = min(len(r) for r in real_batches)
    for k in range(steps):
        got = [i for r in real_batches for i in r[k]["ids"]]
        want = [i for e in expected for i in e[k * local_rows:(k + 1) * local_rows]]
        if got != want:
            failures.append(f"global batch {k}: rows {got} != {want}")
            break
    report["drained_real_per_process"] = workers[0]["real_all"]
    report["pad_counts"] = [w["pad_count"] for w in workers]
    report["devices"] = sorted({b["device"] for w in workers for b in w["batches"]})
    if report["pad_exercised"] and sum(report["pad_counts"]) == 0:
        failures.append("ranks drained unequal counts but no pads were emitted")
    if len({tuple(w["means"]) for w in workers}) != 1:
        failures.append("ranks realized different collective results")

    if resume_processes:
        states = []
        for pid in range(num_processes):
            with open(os.path.join(workdir, f"state_{pid}.pkl"), "rb") as f:
                states.append(pickle.load(f))
        states_path = os.path.join(workdir, "states.pkl")
        with open(states_path, "wb") as f:
            pickle.dump(states, f)
        error = _launch("resume", resume_processes, dataset, workdir, timeout, logs, device,
                        backend, ["--resume-states", states_path])
        if error:
            failures.append(error)
            return report
        resumed = [i for w in _read(workdir, "resume", resume_processes) for i in w["ids"]]
        report["consumed_rows"], report["resumed_rows"] = len(consumed), len(resumed)
        both = sorted(consumed + resumed)
        if both != list(range(total_rows)):
            failures.append(f"resume not exact: {len(both) - len(set(both))} duplicated rows,"
                            f" {len(set(range(total_rows)) - set(both))} missing")
    report["ok"] = not failures
    return report


def run_distributed_write_check(num_processes: int = 2, global_batch: int = 8,
                                timeout: float = 240.0, workdir: Optional[str] = None,
                                device: str = "cuda", backend: Optional[str] = None) -> Dict:
    """``distributed_write_dataset`` through its default barrier; see
    ``_worker_write``."""
    backend = _backend(device, num_processes, backend)
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_wrcheck_")
    os.makedirs(workdir, exist_ok=True)
    report = _report(workdir, num_processes=num_processes, device=device, backend=backend)
    error = _launch("write", num_processes, "unused", workdir, timeout, [], device, backend,
                    ["--global-batch", str(global_batch)])
    if error:
        report["failures"].append(error)
        return report
    workers = _read(workdir, "write", num_processes)
    report["rows_read"] = workers[0]["rows_read"]
    report["files_per_host"] = [w["files"] for w in workers]
    if any(w["rows_read"] != workers[0]["rows_read"] for w in workers):
        report["failures"].append("ranks read back different row counts")
    if any(w["files"] == 0 for w in workers):
        report["failures"].append("a rank wrote no part files")
    report["ok"] = not report["failures"]
    return report


def run_context_parallel_check(num_processes: int = 2, seq: int = 32, dim: int = 32,
                               global_batch: int = 2, timeout: float = 240.0,
                               workdir: Optional[str] = None, device: str = "cuda",
                               backend: Optional[str] = None) -> Dict:
    """Ring and Ulysses attention over sequence-sharded delivery; see
    ``_worker_cp``."""
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.schema import Field, Schema

    if seq % num_processes or dim % _CP_HEADS:
        raise ValueError(f"seq ({seq}) must divide over {num_processes} ranks and dim ({dim})"
                         f" over {_CP_HEADS} heads")
    backend = _backend(device, num_processes, backend)
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_cpcheck_")
    os.makedirs(workdir, exist_ok=True)
    dataset = os.path.join(workdir, f"cp_s{seq}_d{dim}_b{global_batch}")
    if not os.path.exists(dataset):
        rng = np.random.default_rng(11)
        write_dataset(dataset, Schema("CpCheck", [Field(_ID, np.int32),
                                                  Field("x", np.float32, (seq, dim))]),
                      [{_ID: np.int32(i), "x": rng.standard_normal((seq, dim)).astype(np.float32)}
                       for i in range(global_batch)],
                      row_group_size_rows=global_batch)
    report = _report(workdir, num_processes=num_processes, device=device, backend=backend)
    error = _launch("cp", num_processes, dataset, workdir, timeout, [], device, backend,
                    ["--global-batch", str(global_batch)])
    if error:
        report["failures"].append(error)
        return report
    workers = _read(workdir, "cp", num_processes)
    for name in ("ring", "uly"):
        errs = [w.get(f"err_{name}") for w in workers]
        report[f"err_{name}"] = None if None in errs else max(errs)
    report["transport"] = workers[0]["transport"]
    report["devices"] = sorted({w["device"] for w in workers})
    report["ok"] = not report["failures"]
    return report


def run_shuffled_check(num_processes: int = 4, global_batch: int = 8, n_batches: int = 16,
                       seed: int = 9, timeout: float = 300.0, workdir: Optional[str] = None,
                       device: str = "cuda", backend: Optional[str] = None) -> Dict:
    """Seeded shuffled reading with stacked delivery over real processes;
    see ``_worker_shuffled``.  The assertions of the JAX check
    (``petastorm_tpu/parallel/selfcheck.py:424``): (a) every rank realized
    the same global unit sequence, (b) the masked multiset is the dataset
    exactly, (c) the order is the seeded plan's lockstep interleave
    recomputed here, (d) the global |rank correlation| is at most 0.5."""
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.schema import Field, Schema
    from petastorm_tpu_torch.test_util.shuffling_analysis import rank_correlation

    if global_batch % num_processes or n_batches % 2:
        raise ValueError("global_batch must divide over the processes and n_batches be even"
                         " (stack_batches=2)")
    backend = _backend(device, num_processes, backend)
    local_rows = global_batch // num_processes
    total = n_batches * global_batch
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_shufcheck_")
    os.makedirs(workdir, exist_ok=True)
    dataset = os.path.join(workdir, f"shuf_gb{global_batch}_nb{n_batches}_np{num_processes}")
    if not os.path.exists(dataset):
        write_dataset(dataset, Schema("ShufCheck", [Field(_ID, np.int32),
                                                    Field(_VALUE, np.float32, (_VALUE_DIM,))]),
                      [{_ID: np.int32(i), _VALUE: _value_for_ids([i])[0]}
                       for i in range(total)],
                      row_group_size_rows=local_rows)
    report = _report(workdir, num_processes=num_processes, device=device, backend=backend)
    error = _launch("shuffled", num_processes, dataset, workdir, timeout, [], device, backend,
                    ["--global-batch", str(global_batch), "--seed", str(seed)])
    if error:
        report["failures"].append(error)
        return report
    workers = _read(workdir, "shuffled", num_processes)
    failures = report["failures"]
    if len({json.dumps([(u["ids"], u["mask"]) for u in w["units"]]) for w in workers}) != 1:
        failures.append("ranks realized different global unit sequences: the seeded"
                        " permutation diverged across processes")
    if len({tuple(w["means"]) for w in workers}) != 1:
        failures.append("ranks realized different collective results")
    flat: List[int] = []
    for u in workers[0]["units"]:
        for ids_step, mask_step in zip(u["ids"], u["mask"]):
            flat.extend(i for i, m in zip(ids_step, mask_step) if m > 0)
    if sorted(flat) != list(range(total)):
        failures.append(f"shuffled multiset broken: {len(flat)} rows,"
                        f" {len(flat) - len(set(flat))} duplicated (want each of {total} once)")
    if flat == sorted(flat):
        failures.append("delivered order is the written order: nothing shuffled")
    rho = abs(rank_correlation(np.asarray(flat))) if flat else 1.0
    report["rho_global"] = round(float(rho), 4)
    if rho > 0.5:
        failures.append(f"shuffle quality: global |rho|={rho:.3f} > 0.5")
    # the seeded plan is a pure function of (seed, shard): each shard's stream
    # recomputed here and interleaved in lockstep is the delivered order
    per_shard: List[List[int]] = []
    for p in range(num_processes):
        ids: List[int] = []
        with make_reader(dataset, cur_shard=p, shard_count=num_processes,
                         shuffle_row_groups=True, shuffle_seed=seed, num_epochs=1,
                         workers_count=1) as r:
            for cb in r.iter_batches():
                ids.extend(np.asarray(cb.columns[_ID]).astype(int).tolist())
        per_shard.append(ids)
    expect: List[int] = []
    for t in range(n_batches):
        for p in range(num_processes):
            expect.extend(per_shard[p][t * local_rows:(t + 1) * local_rows])
    if flat and flat != expect:
        failures.append("delivered order != the seeded plan's interleave (plan determinism"
                        " broken across processes)")
    report["units"] = len(workers[0]["units"])
    report["devices"] = sorted({u["device"] for w in workers for u in w["units"]})
    report["ok"] = not failures
    return report


def run_mixed_check(num_processes: int = 2, global_batch: int = 8, n_rows: int = 16,
                    timeout: float = 300.0, workdir: Optional[str] = None,
                    device: str = "cuda", backend: Optional[str] = None) -> Dict:
    """``'device-mixed'`` decode across processes; see ``_worker_mixed``.  A
    2-geometry JPEG dataset; every rank decodes only its shard's rows; (a)
    the gathered pixels are identical on every rank, (b) every image is
    within the hybrid tolerance (max 6, mean below 1) of the launcher's host
    decode of the stored bytes and its pad region is zero
    (``petastorm_tpu/parallel/selfcheck.py:565``)."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.schema import Field, Schema
    from petastorm_tpu_torch.test_util.synthetic import synthetic_rgb_image

    backend = _backend(device, num_processes, backend)
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_mixcheck_")
    os.makedirs(workdir, exist_ok=True)
    dataset = os.path.join(workdir, f"mixed_n{n_rows}_gb{global_batch}")
    if not os.path.exists(dataset):
        schema = Schema("MixCheck", [
            Field(_ID, np.int32),
            Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg", quality=92)),
        ])
        write_dataset(dataset, schema,
                      [{_ID: np.int32(i),
                        "image": synthetic_rgb_image(i, *_MIXED_GEOMS[i % len(_MIXED_GEOMS)],
                                                     noise=0)}
                       for i in range(n_rows)],
                      row_group_size_rows=global_batch // num_processes)
    report = _report(workdir, num_processes=num_processes, device=device, backend=backend)
    error = _launch("mixed", num_processes, dataset, workdir, timeout, [], device, backend,
                    ["--global-batch", str(global_batch)])
    if error:
        report["failures"].append(error)
        return report
    workers = _read(workdir, "mixed", num_processes)
    failures = report["failures"]
    arrays = [np.load(os.path.join(workdir, f"mixed_{w['process_id']}.npy")) for w in workers]
    if any(w["ids"] != list(range(n_rows)) for w in workers):
        failures.append("a rank did not observe every row id")
    for w, a in zip(workers[1:], arrays[1:]):
        if not np.array_equal(arrays[0], a):
            failures.append(f"rank {w['process_id']}: gathered decoded pixels differ from"
                            " rank 0's")
            break
    report["geometries_per_rank"] = [w["geometries"] for w in workers]
    report["b2_launches"] = [w["b2_launches"] for w in workers]
    if any(w["b2_general_launches"] for w in workers):
        failures.append("a rank launched B2's general kernel")
    report["devices"] = sorted({w["device"] for w in workers})
    if any(w["geometries"].get("image", 0) > len(_MIXED_GEOMS) for w in workers):
        failures.append(f"a rank decoded more geometries than the dataset holds:"
                        f" {report['geometries_per_rank']}")
    if failures:
        return report
    ref: Dict[int, np.ndarray] = {}
    with make_batch_reader(dataset, shuffle_row_groups=False, num_epochs=1,
                           workers_count=1) as r:
        for cb in r.iter_batches():
            for i, img in zip(np.asarray(cb.columns[_ID]).astype(int), cb.columns["image"]):
                ref[int(i)] = np.asarray(img)
    max_err, mean_err = 0.0, 0.0
    for i in range(n_rows):
        h, w_ = ref[i].shape[:2]
        dev = arrays[0][i]
        diff = np.abs(ref[i].astype(int) - dev[:h, :w_].astype(int))
        max_err = max(max_err, float(diff.max()))
        mean_err = max(mean_err, float(diff.mean()))
        if diff.max() > 6 or diff.mean() >= 1.0:
            failures.append(f"row {i}: device-mixed pixels off by max {diff.max()} / mean"
                            f" {diff.mean():.2f} from the host decode")
            break
        if dev[h:].any() or dev[:, w_:].any():
            failures.append(f"row {i}: pad region not zero")
            break
    report["max_pixel_err"] = max_err
    report["mean_pixel_err"] = round(mean_err, 3)
    report["rows"] = n_rows
    report["ok"] = not failures
    return report


def run_mesh2d_check(num_processes: int = 2, devices_per_process: int = 2,
                     global_batch: int = 8, seq: int = 8, timeout: float = 240.0,
                     workdir: Optional[str] = None, device: str = "cuda",
                     backend: Optional[str] = None) -> Dict:
    """dp x tp delivery and collectives on a ``(num_processes,
    devices_per_process)`` mesh of as many ranks; see ``_worker_mesh2d``
    (``petastorm_tpu/parallel/selfcheck.py:752``)."""
    from petastorm_tpu_torch.etl.writer import write_dataset
    from petastorm_tpu_torch.schema import Field, Schema

    if global_batch % num_processes or global_batch < num_processes:
        raise ValueError(f"global_batch ({global_batch}) must divide over the data dimension"
                         f" ({num_processes})")
    if seq % devices_per_process or _M2D_HIDDEN % devices_per_process:
        raise ValueError(f"seq ({seq}) and the hidden width ({_M2D_HIDDEN}) must divide over"
                         f" the model dimension ({devices_per_process})")
    ranks = num_processes * devices_per_process
    backend = _backend(device, ranks, backend)
    workdir = workdir or tempfile.mkdtemp(prefix="petastorm_torch_m2dcheck_")
    os.makedirs(workdir, exist_ok=True)
    dataset = os.path.join(workdir, f"m2d_b{global_batch}_s{seq}_np{num_processes}")
    if not os.path.exists(dataset):
        write_dataset(dataset, Schema("Mesh2d", [Field(_ID, np.int32),
                                                 Field("tokens", np.int32, (seq,))]),
                      [{_ID: np.int32(i),
                        "tokens": ((i * 7 + np.arange(seq)) % _M2D_VOCAB).astype(np.int32)}
                       for i in range(global_batch * 4)],
                      row_group_size_rows=global_batch // num_processes)
    report = _report(workdir, num_processes=num_processes,
                     devices_per_process=devices_per_process, ranks=ranks, device=device,
                     backend=backend)
    error = _launch("mesh2d", ranks, dataset, workdir, timeout, [], device, backend,
                    ["--global-batch", str(global_batch),
                     "--devices-per-process", str(devices_per_process)])
    if error:
        report["failures"].append(error)
        return report
    workers = _read(workdir, "mesh2d", ranks)
    losses = {w["loss"] for w in workers}
    if len(losses) != 1:
        report["failures"].append(f"ranks realized different losses: {losses}")
    report["loss"], report["ref"] = workers[0]["loss"], workers[0]["ref"]
    report["rel_err"] = max(w["rel_err"] for w in workers)
    report["mesh"] = workers[0]["mesh"]
    report["devices"] = sorted({w["device"] for w in workers})
    report["ok"] = not report["failures"]
    return report


def _main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worker", action="store_true",
                        help="internal: run as a spawned worker process")
    parser.add_argument("--phase", default="pipeline", choices=sorted(_PHASES))
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--settle", type=float, default=1.5)
    parser.add_argument("--resume-states", default=None)
    parser.add_argument("--resume-processes", type=int, default=3)
    parser.add_argument("--seed", type=int, default=9, help="the shuffled check's seed")
    parser.add_argument("--devices-per-process", type=int, default=2,
                        help="the 2-D check's model dimension (ranks = num-processes x this)")
    parser.add_argument("--timeout", type=float, default=240.0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: NCCL when the ranks have distinct cards, else gloo")
    args = parser.parse_args()
    if args.worker:
        _worker_main(args)
        return 0
    common = dict(num_processes=args.num_processes, timeout=args.timeout, device=args.device,
                  backend=args.backend)
    if args.phase == "pipeline":
        report = run_selfcheck(global_batch=args.global_batch,
                               resume_processes=args.resume_processes, settle=args.settle,
                               **common)
    elif args.phase == "cp":
        report = run_context_parallel_check(**common)
    elif args.phase == "write":
        report = run_distributed_write_check(**common)
    elif args.phase == "shuffled":
        report = run_shuffled_check(seed=args.seed, **common)
    elif args.phase == "mixed":
        report = run_mixed_check(**common)
    elif args.phase == "mesh2d":
        report = run_mesh2d_check(devices_per_process=args.devices_per_process, **common)
    else:
        print(f"--phase {args.phase} is not a standalone check (it runs inside the pipeline"
              " check)")
        return 2
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(_main())
