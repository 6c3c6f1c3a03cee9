"""Long-context training with context parallelism, one process per rank.

Port of ``examples/long_context/train_ring_attention.py``.  The loader
delivers sequence-sharded token batches (``CudaDataLoader(mesh=,
shardings={"tokens": (Shard(0), Shard(1))})``, JAX's ``P("data", "seq")``)
and ring attention (or Ulysses) consumes them without any rank holding the
full sequence.  The model is the JAX example's (``:46-72``): an embedding,
causal attention with q = k = v = x over ``heads`` heads of ``head_dim``, an
output product to the vocabulary, the mean next-token cross-entropy over
``B * (S - 1)`` positions and Adam at 1e-3.

Where XLA placed collectives implicitly, this port writes them out:

* each rank's last target is the first token of the next rank's slice of the
  sequence, exchanged once a step over the ``seq`` ring; the global last
  position has no target;
* the loss is the global mean: every rank's sum of its positions' losses,
  summed over the mesh, over ``B * (S - 1)``;
* the gradients of the replicated ``embed`` and ``out`` are summed over the
  mesh (each rank's backward holds the gradient of its own positions' loss;
  the ring's backward has already carried the attention's cross-rank part).

Launch one process per rank::

    torchrun --nproc-per-node N -m \\
        petastorm_tpu_torch.examples.long_context.train_ring_attention_cuda \\
        --strategy ring --data-par 1

The backend is NCCL when the ranks have distinct cards, and gloo when they
share one (the ring's and the all-to-all's CUDA transfers then go through
pinned host buffers; ``--device cpu`` runs gloo on host tensors).  The
defaults are the JAX example's smoke sizes (4 heads of 16, 128 tokens,
vocabulary 256).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from petastorm_tpu_torch.cuda.loader import make_cuda_loader
from petastorm_tpu_torch.etl.writer import write_dataset
from petastorm_tpu_torch.ops import ring_attention as ring_ops
from petastorm_tpu_torch.ops.ring_attention import Ring, ring_attention
from petastorm_tpu_torch.ops.ulysses import ulysses_attention
from petastorm_tpu_torch.parallel.mesh import all_reduce_, mesh_group, transport_name
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.schema import Field, Schema

#: the token delivery: rows over "data", the sequence over "seq"
TOKEN_SHARDING = {"tokens": (Shard(0), Shard(1))}


def generate_dataset(url: str, rows: int, seq_len: int, vocab: int, seed: int = 0) -> None:
    """``rows`` rows of ``seq_len`` random int32 tokens in ``[0, vocab)`` (the
    JAX example's rows, drawn in the same order from the same seed)."""
    rng = np.random.default_rng(seed)
    schema = Schema("LongSeq", [Field("tokens", np.int32, (seq_len,))])
    write_dataset(url, schema,
                  ({"tokens": rng.integers(0, vocab, seq_len).astype(np.int32)}
                   for _ in range(rows)),
                  row_group_size_rows=max(rows // 4, 1), mode="overwrite")


def init_params(vocab: int, d_model: int, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """``embed`` (vocab, d_model) and ``out`` (d_model, vocab), normal * 0.02,
    drawn on the host from ``seed`` (the same on every rank), float32."""
    gen = torch.Generator().manual_seed(seed)
    return {"embed": (torch.randn(vocab, d_model, generator=gen) * 0.02).to(device),
            "out": (torch.randn(d_model, vocab, generator=gen) * 0.02).to(device)}


class TrainStep:
    """One training step on this rank's block of tokens ``(B_local, S_local)``.

    ``loss_and_grads(tokens)`` returns the global mean loss (0-d, detached)
    and the mesh-summed gradients without updating; ``update(grads)`` takes
    one Adam step; ``step(tokens)`` does both.  ``plain=True`` runs B4's
    plain versions (the comparison of the first step).  ``reduce_s`` sums
    the host seconds of the loss's and gradients' all-reduce (from the
    finished backward to the reduced gradients)."""

    def __init__(self, params: Dict[str, torch.Tensor], mesh, heads: int, head_dim: int,
                 strategy: str = "ring", lr: float = 1e-3):
        if strategy not in ("ring", "ulysses"):
            raise ValueError(f"strategy must be 'ring' or 'ulysses', got {strategy!r}")
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.optimizer = torch.optim.Adam(self.params.values(), lr=lr)
        self.mesh, self.heads, self.head_dim = mesh, heads, head_dim
        self.attend = ring_attention if strategy == "ring" else ulysses_attention
        self.ring = Ring(mesh, "seq")
        self.group = mesh_group(mesh)
        self.reduce_s = 0.0
        self.attention: Optional[torch.Tensor] = None

    def _targets(self, tokens: torch.Tensor):
        """Next-token targets of this rank's positions and their mask: the
        last target comes from the next rank's first token; the global last
        position has none."""
        first_of_next = tokens[:, :1].contiguous()
        if self.ring.size > 1:
            (first_of_next,) = self.ring.shift([first_of_next], forward=False).wait()
        targets = torch.cat([tokens[:, 1:], first_of_next], dim=1).long()
        valid = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        if self.ring.index == self.ring.size - 1:
            valid[:, -1] = 0.0
        return targets, valid

    def loss_and_grads(self, tokens: torch.Tensor, global_batch: int, seq_len: int,
                       plain: bool = False, keep_attention: bool = False):
        b, s = tokens.shape
        p = self.params
        targets, valid = self._targets(tokens)
        x = F.embedding(tokens.long(), p["embed"])
        x = x.reshape(b, s, self.heads, self.head_dim).transpose(1, 2)
        o = self.attend(x, x, x, self.mesh, causal=True, plain=plain)
        if keep_attention:  # this rank's attention output, for the first-step check
            self.attention = o.detach()
        o = o.transpose(1, 2).reshape(b, s, self.heads * self.head_dim)
        logits = o @ p["out"]
        nll = F.cross_entropy(logits.reshape(b * s, -1), targets.reshape(-1), reduction="none")
        local = (nll * valid.reshape(-1)).sum() / (global_batch * (seq_len - 1))
        grads = torch.autograd.grad(local, [p["embed"], p["out"]])
        grads = {"embed": grads[0], "out": grads[1]}
        loss = local.detach().clone()
        _sync(loss.device)
        t0 = time.perf_counter()
        for t in [loss, *grads.values()]:
            all_reduce_(t, self.group)
        _sync(loss.device)
        self.reduce_s += time.perf_counter() - t0
        return loss, grads

    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        for name, g in grads.items():
            self.params[name].grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, tokens: torch.Tensor, global_batch: int, seq_len: int) -> torch.Tensor:
        loss, grads = self.loss_and_grads(tokens, global_batch, seq_len)
        self.update(grads)
        return loss


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def train(dataset_url: str, steps: int, global_batch: int, seq_len: int, vocab: int,
          heads: int = 4, head_dim: int = 16, data_par: int = 1, strategy: str = "ring",
          device="cuda", warmup: int = 0, check_plain: bool = False, seed: int = 0,
          params: Optional[Dict[str, torch.Tensor]] = None,
          reader_kwargs: Optional[Dict] = None, verbose: bool = True) -> Dict:
    """``steps`` steps on this rank (the process group is initialized, one
    rank a process): a ``("data", "seq")`` mesh of ``data_par`` x
    ``world / data_par``; returns the losses and, over the steps after
    ``warmup``, the step ms, tokens/s, the input-idle share
    (``consumer_wait_s`` over the wall time), the peak device memory, B4's
    launches on this rank and the transport.  ``check_plain`` also runs the
    first step with B4's plain versions on the same params and batch and
    reports the relative distance of the loss, of this rank's attention output
    and of each gradient (at a random init the loss is close to ln(vocab)
    whatever the attention gives, so the attention output and the gradients
    are what tell a wrong kernel).  ``params``
    (default: :func:`init_params` from ``seed``) start the run, and the
    report's ``params`` holds them after the last step; ``reader_kwargs`` go
    to the reader (``make_reader``, endless)."""
    from torch.distributed.device_mesh import init_device_mesh

    if steps <= warmup:
        raise ValueError(f"steps ({steps}) must exceed warmup ({warmup})")
    device = torch.device(device)
    world = dist.get_world_size()
    if world % data_par:
        raise ValueError(f"data_par {data_par} does not divide the world size {world}")
    backend = dist.get_backend()
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (data_par, world // data_par),
                            mesh_dim_names=("data", "seq"))
    params = params if params is not None else init_params(vocab, heads * head_dim, seed)
    step = TrainStep({k: v.to(device) for k, v in params.items()}, mesh, heads, head_dim,
                     strategy)
    report: Dict = {"strategy": strategy, "mesh": [data_par, world // data_par],
                    "backend": backend, "transport": transport_name(step.ring.group, device),
                    "heads": heads, "head_dim": head_dim, "vocab": vocab,
                    "global_batch": global_batch, "seq_len": seq_len}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses: List[float] = []
    with make_cuda_loader(dataset_url, global_batch, mesh=mesh, shardings=TOKEN_SHARDING,
                          reader_factory=make_reader, num_epochs=None, device=device,
                          fields=["tokens"], **(reader_kwargs or {})) as loader:
        batches = iter(loader)
        ring_ops.reset_launch_counts()
        for i in range(steps):
            if i == warmup:
                _sync(device)
                start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
                reduce0 = step.reduce_s
            tokens = next(batches)["tokens"]
            if i == 0 and check_plain:
                plain_loss, plain_grads = step.loss_and_grads(tokens, global_batch, seq_len,
                                                              plain=True, keep_attention=True)
                plain_attention = step.attention
                report["plain_cuda_calls_in_check"] = ring_ops.plain_cuda_calls()
                for fn in ring_ops.PLAIN_VERSIONS:
                    fn.cuda_calls = 0
                loss, grads = step.loss_and_grads(tokens, global_batch, seq_len,
                                                  keep_attention=True)
                report["first_step"] = {
                    "loss": float(loss), "plain_loss": float(plain_loss),
                    "loss_rel_err": abs(float(loss) - float(plain_loss)) / abs(float(plain_loss)),
                    "attention_rel_err": _max_rel_err(step.attention, plain_attention),
                    "grad_rel_err": {k: _max_rel_err(grads[k], plain_grads[k]) for k in grads}}
                del plain_grads, plain_attention
                step.attention = None
                step.update(grads)
            else:
                loss = step.step(tokens, global_batch, seq_len)
            losses.append(float(loss))
        _sync(device)
        seconds = time.perf_counter() - start
        wait = loader.diagnostics()["consumer_wait_s"] - wait0
    timed = steps - warmup
    report.update(
        losses=losses, timed_steps=timed, seconds=seconds,
        step_ms=1e3 * seconds / timed, tokens_per_s=timed * global_batch * seq_len / seconds,
        allreduce_ms=1e3 * (step.reduce_s - reduce0) / timed,
        consumer_wait_share=wait / seconds,
        launches={"block_attention_fwd": ring_ops.block_attention_fwd.launches,
                  "block_attention_bwd": ring_ops.block_attention_bwd.launches,
                  "attention_row_delta": ring_ops.attention_row_delta.launches},
        plain_cuda_calls=ring_ops.plain_cuda_calls(),
        params={k: v.detach() for k, v in step.params.items()})
    if device.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if verbose and dist.get_rank() == 0:
        print(f"mesh {report['mesh']} {strategy} ({report['transport']}):"
              f" loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return report


def _init_from_env(device: str) -> torch.device:
    """Initialize the process group from torchrun's environment and pick this
    rank's device: NCCL when the ranks have distinct cards, gloo when they
    share one or run on the host."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda was requested but no CUDA GPU is available;"
                               " pass --device cpu to run on the host")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if "MASTER_ADDR" not in os.environ:
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", default=None,
                        help="dataset URL (default: generated under the temp directory)")
    parser.add_argument("--rows", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--head-dim", type=int, default=16)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=0)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--data-par", type=int, default=1)
    parser.add_argument("--strategy", choices=("ring", "ulysses"), default="ring")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--check-plain", action="store_true",
                        help="hold the first step against B4's plain versions")
    parser.add_argument("--report", default=None,
                        help="write this rank's report as JSON to <report>.<rank>.json")
    args = parser.parse_args(argv)
    device = _init_from_env(args.device)
    try:
        url = args.dataset or os.path.join(
            tempfile.gettempdir(), f"longctx_cuda_{os.environ['MASTER_PORT']}", "seqs")
        if dist.get_rank() == 0 and (args.dataset is None or not os.path.exists(url)):
            generate_dataset(url, args.rows, args.seq_len, args.vocab)
        dist.barrier()
        report = train(url, args.steps, args.global_batch, args.seq_len, args.vocab,
                       heads=args.heads, head_dim=args.head_dim, data_par=args.data_par,
                       strategy=args.strategy, device=device, warmup=args.warmup,
                       check_plain=args.check_plain)
        report.pop("params")
        if args.report:
            with open(f"{args.report}.{dist.get_rank()}.json", "w") as f:
                json.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
