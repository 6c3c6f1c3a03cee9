"""Ulysses-style sequence parallelism: all-to-all head/sequence resharding.

Counterpart of ``petastorm_tpu/ops/ulysses.py``: the second context-parallel
strategy beside ring attention.  One ``all_to_all_single`` of q, k and v
stacked re-shards them from sequence-sharded (every rank holds S/P of all H
heads) to head-sharded (every rank holds all of S for H/P heads), full
attention runs locally through kernel B4 (one block: ``o / l``), and the
inverse ``all_to_all_single`` brings the output back to sequence sharding.
``H % P != 0`` raises ``ValueError`` (``:60-63``).

Both all-to-alls are differentiable (an all-to-all of equal splits is its
own adjoint, so the backward is the same exchange of the gradient), and the
attention's gradient is B4's backward.  On gloo a CUDA tensor goes through a
pinned host buffer, as for the ring (``parallel.mesh.transport_name``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from petastorm_tpu_torch.ops.ring_attention import Ring, attention
from petastorm_tpu_torch.parallel.mesh import to_host


def _all_to_all(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 (one slice a rank) of ``ring``'s group."""
    x = x.contiguous()
    if ring.staged(x):
        host = to_host(x)
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=ring.group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ring.group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring: Ring):
        ctx.ring = ring
        return _all_to_all(x, ring)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.ring), None


def ulysses_attention(q, k, v, mesh, seq_dim: str = "seq", causal: bool = False,
                      scale: Optional[float] = None, plain: bool = False) -> torch.Tensor:
    """Exact attention over the mesh dimension ``seq_dim`` by two all-to-alls
    (``:48 ulysses_attention_sharded``, ``:81 ulysses_attention``).

    q, k, v are this rank's local sequence slices ``(B, H, S_local, D)``,
    with H divisible by the dimension's size.  Differentiable; float32
    inside (``:70``), the output in q's dtype.  ``plain=True`` runs B4's
    plain versions on any device (comparisons).
    """
    ring = Ring(mesh, seq_dim)
    p = ring.size
    b, h, s_local, d = q.shape
    if h % p:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by the '{seq_dim}' axis"
            f" size ({p}); use ring_attention for indivisible head counts")
    if p == 1:
        return attention(q, k, v, causal=causal, scale=scale, plain=plain)
    hp = h // p
    # (3, B, H, S/P, D) -> one slice a destination rank: its group of heads
    qkv = torch.stack([q, k, v]).reshape(3, b, p, hp, s_local, d).permute(2, 0, 1, 3, 4, 5)
    qkv = _AllToAll.apply(qkv, ring)  # slice i: rank i's sequence block of my heads
    qkv = qkv.permute(1, 2, 3, 0, 4, 5).reshape(3, b, hp, p * s_local, d)
    o = attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale, plain=plain)
    o = o.reshape(b, hp, p, s_local, d).permute(2, 0, 1, 3, 4)
    o = _AllToAll.apply(o, ring)  # slice i: head group i of my sequence block
    return o.permute(1, 0, 2, 3, 4).reshape(b, h, s_local, d)
