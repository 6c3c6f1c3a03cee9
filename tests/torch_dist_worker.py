"""Gloo worker processes for the port's multi-process parity tests.

``launch(case, nprocs, args, timeout)`` starts ``nprocs`` copies of this file
(``python tests/torch_dist_worker.py <case> <args>``), one rank each, through
the port's ``parallel.launch.run_ranks`` (torchrun's variables, a gloo group
on localhost), waits for them within ``timeout`` seconds and raises (the test
fails) when any worker exits non-zero or the time runs out.  A worker imports
torch and the port only, never jax or a test module; it reads its inputs from
and writes its results (and its log) to files under ``args['out']``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(case: str, nprocs: int, args: dict, timeout: float = 120.0) -> None:
    """Run ``case`` on ``nprocs`` gloo ranks; raise on a failed or late worker."""
    from petastorm_tpu_torch.parallel.launch import run_ranks

    error = run_ranks([sys.executable, os.path.abspath(__file__), case, json.dumps(args)],
                      nprocs, timeout, os.path.join(args["out"], case),
                      env={"OMP_NUM_THREADS": "1"})
    if error:
        raise AssertionError(f"{case} on {nprocs} gloo ranks failed: {error}")


# -- worker side ------------------------------------------------------------------

def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "seq"))


def _attention(rank, world, args):
    """Ring and Ulysses forward and gradients on a (1, P) mesh, the local
    slices of the global inputs in ``args['inputs']``."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.ulysses import ulysses_attention

    mesh = _mesh((1, world))
    data = np.load(args["inputs"])
    s = data["q"].shape[2]
    sl = slice(rank * s // world, (rank + 1) * s // world)
    out = {}
    for strategy, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            q, k, v = (torch.from_numpy(data[n][:, :, sl]).requires_grad_() for n in "qkv")
            o = fn(q, k, v, mesh, causal=causal)
            (o * torch.from_numpy(data["w"][:, :, sl])).sum().backward()
            key = f"{strategy}_{int(causal)}"
            out[f"{key}_out"] = o.detach().numpy()
            for n, t in zip("qkv", (q, k, v)):
                out[f"{key}_d{n}"] = t.grad.numpy()
        q, k, v = (torch.from_numpy(data[n][:, :, sl]).to(torch.bfloat16) for n in "qkv")
        o = fn(q, k, v, mesh, causal=True)
        assert o.dtype == torch.bfloat16, o.dtype
        out[f"{strategy}_bf16_out"] = o.float().numpy()
    q = torch.from_numpy(data["q"][:, :3, sl])
    try:
        ulysses_attention(q, q, q, mesh)
    except ValueError as exc:
        out["indivisible"] = np.array(str(exc))
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"), **out)


def _loader(rank, world, args):
    """Sequence-sharded delivery through ``make_cuda_loader`` on a mesh of
    ``args['mesh']``: every batch's blocks, and this rank's slices."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard

    from petastorm_tpu_torch.cuda.loader import make_cuda_loader
    from petastorm_tpu_torch.parallel.mesh import batch_block, local_data_slice
    from petastorm_tpu_torch.reader import make_reader

    mesh = _mesh(args["mesh"])
    placements = (Shard(0), Shard(1))
    gb, seq = args["global_batch"], args["seq_len"]
    with make_cuda_loader(args["url"], gb, mesh=mesh, shardings={"tokens": placements},
                          reader_factory=make_reader, device="cpu", fields=["tokens", "id"],
                          shuffle_row_groups=False, workers_count=1, num_epochs=1) as loader:
        batches = [(b["tokens"].numpy(), b["id"].numpy()) for b in loader]
    sl = local_data_slice(mesh, placements, (gb, seq))
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"),
             tokens=np.stack([t for t, _ in batches]), ids=np.stack([i for _, i in batches]),
             coord=np.array(mesh.get_coordinate()),
             slice=np.array([[s.start, s.stop] for s in sl]),
             block=np.array(batch_block(mesh, placements)),
             torch_version=np.array(torch.__version__))


def _drain(rank, world, args):
    """Consume one batch, settle, then drain through the default collective
    (``all_gather_counts=None``) with unequal shards: every rank steps as
    often as the one with the most, the short ranks on zero pads."""
    import numpy as np
    from torch.distributed.tensor import Shard

    from petastorm_tpu_torch.cuda.loader import VALID_ROWS, make_cuda_loader
    from petastorm_tpu_torch.reader import make_reader

    mesh = _mesh((world, 1))
    with make_cuda_loader(args["url"], args["global_batch"], mesh=mesh,
                          shardings={"tokens": (Shard(0), Shard(1))},
                          reader_factory=make_reader, device="cpu", fields=["tokens", "id"],
                          shuffle_row_groups=False, workers_count=1, num_epochs=1,
                          drop_last=False, valid_mask_field="mask", prefetch=4) as loader:
        it = iter(loader)
        first = next(it)
        time.sleep(args["settle"])
        drained = list(loader.drain())
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"),
             first_ids=first["id"].numpy(),
             valid=np.array([int(b.get(VALID_ROWS, -1)) for b in drained]),
             masks=np.stack([b["mask"].numpy() for b in drained]),
             ids=np.stack([b["id"].numpy() for b in drained]),
             tokens_shape=np.array([b["tokens"].shape for b in drained]))


def _trainer(rank, world, args):
    """Two steps of the long-context trainer from the given params, ring then
    Ulysses, on a mesh of ``args['data_par']`` x ``world / data_par``."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.convert import (jax_from_long_context_params,
                                             long_context_params_from_jax)
    from petastorm_tpu_torch.examples.long_context import train_ring_attention_cuda as lc

    data = np.load(args["params"])
    params = long_context_params_from_jax({k: data[k] for k in ("embed", "out")})
    out = {}
    for strategy in ("ring", "ulysses"):
        report = lc.train(args["url"], 2, args["global_batch"], args["seq_len"], args["vocab"],
                          heads=args["heads"], head_dim=args["head_dim"],
                          data_par=args["data_par"], strategy=strategy,
                          device=torch.device("cpu"), params=params, verbose=False,
                          reader_kwargs={"shuffle_row_groups": False, "workers_count": 1})
        out[f"{strategy}_losses"] = np.array(report["losses"])
        for k, v in jax_from_long_context_params(report["params"]).items():
            out[f"{strategy}_{k}"] = v
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"), **out)


def _dp_step(rank, world, args):
    """Data-parallel ResNet steps: each rank runs ``TrainStep`` (on the
    default group) on its block of the global batches in ``args['inputs']``,
    from the state in ``args['state']``: the whole step on explicit boxes
    and flips (``feed='augment'``), or the update on given normalized inputs
    (``feed='jax-inputs'``).  Saves the losses and the leaves."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer
    from petastorm_tpu_torch.models.resnet import ResNet

    data = np.load(args["inputs"])
    model = ResNet([1, 1], num_classes=args["classes"], num_filters=8, dtype=torch.float32,
                   device="cpu")
    model.load_state_dict(torch.load(args["state"]), strict=True)
    step = trainer.TrainStep(model, args["classes"], args["side"], group=dist.group.WORLD,
                             block=(rank, world))
    losses = []
    for i in range(data["labels"].shape[0]):
        n = data["labels"].shape[1] // world
        rows = slice(rank * n, (rank + 1) * n)
        labels = torch.from_numpy(data["labels"][i, rows]).long()
        if args["feed"] == "augment":
            loss = step(torch.from_numpy(data["images"][i, rows]), labels,
                        boxes=torch.from_numpy(data["boxes"][i, rows]),
                        flips=torch.from_numpy(data["flips"][i, rows]))
        else:
            x = torch.from_numpy(data["x"][i, rows]).to(torch.bfloat16)
            loss = step.update(x, labels)
        losses.append(float(loss))
    out = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    out["losses"] = np.array(losses)
    out["digest"] = np.array(trainer.leaves_digest(step))
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"), **out)


def _packed(rank, world, args):
    """The packed token loader over a mesh of ``args['mesh']``: every
    delivered block of this rank, in order."""
    import numpy as np
    from torch.distributed.tensor import Replicate, Shard

    from petastorm_tpu_torch.sequence import make_packed_sequence_loader

    mesh = _mesh(args["mesh"])
    spec = (Shard(0), Replicate())
    fields = ("tokens", "segment_ids", "positions", "loss_mask")
    urls = args["urls"] if len(args["urls"]) > 1 else args["urls"][0]
    out = {f: [] for f in fields}
    with make_packed_sequence_loader(urls, args["global_batch"], args["seq_len"],
                                     weights=args.get("weights"), seed=args["seed"],
                                     device="cpu", workers_count=1,
                                     loader_kwargs={"mesh": mesh,
                                                    "shardings": {f: spec for f in fields}}
                                     ) as loader:
        for batch in loader:
            for f in fields:
                out[f].append(batch[f].numpy())
    np.savez(os.path.join(args["out"], f"rank{rank}.npz"),
             **{f: np.concatenate(v) for f, v in out.items()})


CASES = {"attention": _attention, "loader": _loader, "drain": _drain, "trainer": _trainer,
         "dp_step": _dp_step, "packed": _packed}


def _main() -> None:
    case, args = sys.argv[1:3]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        CASES[case](dist.get_rank(), dist.get_world_size(), json.loads(args))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main()
