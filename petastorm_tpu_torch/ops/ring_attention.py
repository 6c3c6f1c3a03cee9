"""Ring attention over a sequence-sharded mesh dimension (context parallelism).

Counterpart of ``petastorm_tpu/ops/ring_attention.py``.  Each rank holds the
local sequence slice ``(B, H, S_local, D)`` of q, k and v (the loader's
``(Shard(0), Shard(1))`` token delivery, embedded), and computes exact
softmax attention over the whole sequence by passing its K/V block around
the ring of the mesh's ``seq`` dimension: after ``t`` rotations rank ``i``
holds the block that started at rank ``i - t``.  Each visited block is merged
into a running ``(o, l, m)`` by log-sum-exp rescaling, so no rank ever holds
the ``S x S`` scores or the full sequence.  Under ``causal`` the blocks wholly
in the future are skipped (``:104-109``).

The block computation is kernel B4 (``csrc/block_attention.cu``), which
replaces the XLA einsums of ``_block_attention`` (``:40``) and ``_merge``
(``:30``): its forward merges into the running ``(o, l, m)`` in place, and
its backward (flash-attention's, from the saved log-sum-exp) adds a block's
dq, dk and dv to accumulators.  A CUDA tensor launches the kernel or raises;
only a CPU tensor takes the plain PyTorch versions (``_block_attention``,
``_merge``, ``block_attention_fwd_reference``,
``block_attention_bwd_reference``), which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against.  B4 is bound by
float32 operations, not bytes: ``4 * Sq * Sk * D`` flops a forward block a
(batch, head), five products where the forward does two backward.  Its
products run on the tensor cores in error-compensated TF32, three TF32
products a float32 one (``csrc/block_attention.cu`` says how and why).  Its
first kernels, SIMT float32, stay reachable as ``block_attention_fwd_simt``
and ``block_attention_bwd_simt``, a yardstick that no path calls.

The gradient is a ``torch.autograd.Function`` over the whole ring: JAX gets
it by differentiating ``ppermute``, and ``torch.distributed`` differentiates
no send or receive.  The forward saves q, the local K and V, the output and
the log-sum-exp; the backward rotates K and V around the ring again, carrying
the dK and dV accumulators with them, and after the last rotation each block's
accumulated gradient is back on the rank that owns it.

K and V move by ``torch.distributed.batch_isend_irecv`` over the ``seq``
dimension's group, started before a block's compute so the two overlap.
NCCL sends device tensors directly; gloo sends no CUDA tensor point to point,
so on gloo (two ranks sharing one card) a CUDA block goes through a pinned
host buffer (``parallel.mesh.transport_name`` names the route a phase took).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from petastorm_tpu_torch.cuda import build
from petastorm_tpu_torch.parallel.mesh import mesh_dim, staged, to_host

#: the largest head width B4 takes (kMaxD in csrc/block_attention.cu)
MAX_HEAD_DIM = 128


def _configure(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.pst_block_attention_fwd.restype = ctypes.c_int
    lib.pst_block_attention_fwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, f, i, ll, ll, p]
    lib.pst_block_attention_bwd.restype = ctypes.c_int
    lib.pst_block_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, f, i, ll,
                                            ll, p]
    lib.pst_attention_row_delta.restype = ctypes.c_int
    lib.pst_attention_row_delta.argtypes = [p, p, p, ll, i, p]
    for kind in ("fwd", "bwd"):
        main, simt = getattr(lib, f"pst_block_attention_{kind}"), getattr(
            lib, f"pst_block_attention_{kind}_simt")
        simt.restype, simt.argtypes = main.restype, main.argtypes


# -- plain PyTorch versions ---------------------------------------------------

def _merge(o, l, m, o_new, l_new, m_new):
    """Merge two partial attention results with log-sum-exp rescaling
    (``:30``).  A side whose row max is -inf (nothing attended yet) weighs 0,
    where the JAX function gives 0 * exp(nan) when both sides are empty."""
    m_out = torch.maximum(m, m_new)
    alpha = torch.where(m == -torch.inf, 0.0, torch.exp(m - m_out))
    beta = torch.where(m_new == -torch.inf, 0.0, torch.exp(m_new - m_out))
    l_out = l * alpha + l_new * beta
    o_out = o * alpha[..., None] + o_new * beta[..., None]
    return o_out, l_out, m_out


def _block_attention(q, k, v, scale, mask):
    """Partial attention of q against one K/V block (``:40``).

    q: (B, H, Sq, D); k, v: (B, H, Sk, D); mask: (Sq, Sk) bool or None.
    Returns the unnormalized o (B, H, Sq, D), the row sums l and the row
    maxes m (B, H, Sq).  A fully masked row gives m = -inf, l = 0, o = 0.
    """
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, l, torch.where(finite, m, -torch.inf)


def causal_mask(q_offset: int, k_offset: int, sq: int, sk: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key ``k_offset + j`` is visible to query ``q_offset + i``."""
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = k_offset + torch.arange(sk, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def _count_plain(fn, tensor: torch.Tensor) -> None:
    if tensor.is_cuda:
        fn.cuda_calls += 1


def block_attention_fwd_reference(q, k, v, o, l, m, scale: float, causal: bool = False,
                                  q_offset: int = 0, k_offset: int = 0) -> None:
    """Plain version of B4's forward: :func:`_block_attention` of one block,
    merged into the running ``(o, l, m)`` in place.  ``cuda_calls`` counts
    the calls on a CUDA tensor (comparisons only; no path takes it there)."""
    _count_plain(block_attention_fwd_reference, q)
    mask = causal_mask(q_offset, k_offset, q.shape[2], k.shape[2], q.device) if causal else None
    o_new, l_new, m_new = _block_attention(q, k, v, scale, mask)
    o_out, l_out, m_out = _merge(o, l, m, o_new, l_new, m_new)
    o.copy_(o_out)
    l.copy_(l_out)
    m.copy_(m_out)


def block_attention_bwd_reference(q, k, v, dout, lse, delta, dq, dk, dv, scale: float,
                                  causal: bool = False, q_offset: int = 0,
                                  k_offset: int = 0) -> None:
    """Plain version of B4's backward: one block's dq, dk and dv from the
    rows' log-sum-exp ``lse`` and ``delta = rowsum(dout * out)``, added to the
    accumulators in place.  ``cuda_calls`` as for the forward."""
    _count_plain(block_attention_bwd_reference, q)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    ok = torch.isfinite(lse)[..., None]
    if causal:
        ok = ok & causal_mask(q_offset, k_offset, q.shape[2], k.shape[2], q.device)
    p = torch.where(ok, torch.exp(scores - torch.where(torch.isfinite(lse), lse, 0.0)[..., None]),
                    0.0)
    dv += torch.einsum("bhqk,bhqd->bhkd", p, dout)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - delta[..., None])
    dq += torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk += torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale


block_attention_fwd_reference.cuda_calls = 0
block_attention_bwd_reference.cuda_calls = 0


def attention_row_delta_reference(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward's ``delta = rowsum(dout * out)``;
    ``cuda_calls`` as for the forward."""
    _count_plain(attention_row_delta_reference, out)
    return (dout * out).sum(dim=-1)


attention_row_delta_reference.cuda_calls = 0


# -- the kernel's wrappers ------------------------------------------------------

def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    """Device, dtype, shape and contiguity checks of a B4 launch: every
    tensor float32, contiguous, on one CUDA device, with its expected shape."""
    device = None
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got"
                             f" {getattr(t, 'device', type(t))}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, the others on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous; call .contiguous()")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected"
                             f" {tuple(shapes[key])}")
    return device


def _dims(name: str, q: torch.Tensor, k: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q (B, H, Sq, D) and k, v (B, H, Sk, D), got"
                         f" {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head width {d} is outside B4's 1..{MAX_HEAD_DIM}")
    return b, h, sq, k.shape[2], d


def _launch_fwd(entry: str, q, k, v, o, l, m, scale, causal, q_offset, k_offset) -> None:
    b, h, sq, sk, d = _dims("block_attention_fwd", q, k)
    device = _check("block_attention_fwd", dict(q=q, k=k, v=v, o=o, l=l, m=m),
                    dict(q=(b, h, sq, d), k=(b, h, sk, d), v=(b, h, sk, d), o=(b, h, sq, d),
                         l=(b, h, sq), m=(b, h, sq)))
    lib = build.load("block_attention", _configure)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            b * h, sq, sk, d, float(scale), int(bool(causal)), int(q_offset), int(k_offset),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block attention forward launch failed (error {err})")


def _launch_bwd(entry: str, q, k, v, dout, lse, delta, dq, dk, dv, scale, causal, q_offset,
                k_offset) -> None:
    b, h, sq, sk, d = _dims("block_attention_bwd", q, k)
    device = _check("block_attention_bwd",
                    dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv),
                    dict(q=(b, h, sq, d), k=(b, h, sk, d), v=(b, h, sk, d),
                         dout=(b, h, sq, d), lse=(b, h, sq), delta=(b, h, sq),
                         dq=(b, h, sq, d), dk=(b, h, sk, d), dv=(b, h, sk, d)))
    lib = build.load("block_attention", _configure)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d,
            float(scale), int(bool(causal)), int(q_offset), int(k_offset),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block attention backward launch failed (error {err})")


def block_attention_fwd(q, k, v, o, l, m, scale: float, causal: bool = False,
                        q_offset: int = 0, k_offset: int = 0) -> None:
    """One block of attention merged into the running ``(o, l, m)`` in place:
    kernel B4's forward on CUDA tensors (``block_attention_fwd.launches``
    counts its launches), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        block_attention_fwd_reference(q, k, v, o, l, m, scale, causal, q_offset, k_offset)
        return
    _launch_fwd("pst_block_attention_fwd", q, k, v, o, l, m, scale, causal, q_offset, k_offset)
    block_attention_fwd.launches += 1


def block_attention_bwd(q, k, v, dout, lse, delta, dq, dk, dv, scale: float,
                        causal: bool = False, q_offset: int = 0, k_offset: int = 0) -> None:
    """One block's dq, dk and dv added to the accumulators in place: kernel
    B4's backward (its dK/dV and dQ kernels) on CUDA tensors
    (``block_attention_bwd.launches`` counts the pairs), the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        block_attention_bwd_reference(q, k, v, dout, lse, delta, dq, dk, dv, scale, causal,
                                      q_offset, k_offset)
        return
    _launch_bwd("pst_block_attention_bwd", q, k, v, dout, lse, delta, dq, dk, dv, scale, causal,
                q_offset, k_offset)
    block_attention_bwd.launches += 1


def block_attention_fwd_simt(q, k, v, o, l, m, scale: float, causal: bool = False,
                             q_offset: int = 0, k_offset: int = 0) -> None:
    """:func:`block_attention_fwd` by B4's SIMT float32 kernel, CUDA tensors
    only: the yardstick the tensor-core kernel is timed against in turns and
    a second oracle.  No path of the package calls it; it counts nothing."""
    _launch_fwd("pst_block_attention_fwd_simt", q, k, v, o, l, m, scale, causal, q_offset,
                k_offset)


def block_attention_bwd_simt(q, k, v, dout, lse, delta, dq, dk, dv, scale: float,
                             causal: bool = False, q_offset: int = 0, k_offset: int = 0) -> None:
    """:func:`block_attention_bwd` by B4's SIMT float32 kernels, as
    :func:`block_attention_fwd_simt`."""
    _launch_bwd("pst_block_attention_bwd_simt", q, k, v, dout, lse, delta, dq, dk, dv, scale,
                causal, q_offset, k_offset)


def attention_row_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dout * out)`` (B, H, S) of (B, H, S, D) float32 tensors: B4's
    delta kernel on CUDA tensors (``attention_row_delta.launches``), the
    plain version on CPU tensors."""
    if out.device.type == "cpu":
        return attention_row_delta_reference(out, dout)
    if out.dim() != 4:
        raise ValueError(f"attention_row_delta: (B, H, S, D) tensors, got {tuple(out.shape)}")
    device = _check("attention_row_delta", dict(out=out, dout=dout),
                    dict(out=out.shape, dout=out.shape))
    delta = torch.empty(out.shape[:-1], dtype=torch.float32, device=device)
    lib = build.load("block_attention", _configure)
    with torch.cuda.device(device):
        err = lib.pst_attention_row_delta(out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                                          delta.numel(), out.shape[-1],
                                          torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention row delta launch failed (error {err})")
    attention_row_delta.launches += 1
    return delta


block_attention_fwd.launches = 0
block_attention_bwd.launches = 0
attention_row_delta.launches = 0
PLAIN_VERSIONS = (block_attention_fwd_reference, block_attention_bwd_reference,
                  attention_row_delta_reference)


def reset_launch_counts() -> None:
    """B4's launch counts and the plain versions' CUDA call counts to 0."""
    for fn in (block_attention_fwd, block_attention_bwd, attention_row_delta):
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.cuda_calls = 0


def plain_cuda_calls() -> int:
    """The plain versions' calls on CUDA tensors since the last reset."""
    return sum(fn.cuda_calls for fn in PLAIN_VERSIONS)


# -- the ring -------------------------------------------------------------------

class Ring:
    """One mesh dimension as a ring of ranks: its group, this rank's index
    and size, the neighbours' global ranks, and the transfers between them."""

    def __init__(self, mesh, dim_name: str = "seq"):
        d = mesh_dim(mesh, dim_name)
        self.group = mesh.get_group(d)
        self.size = int(mesh.size(d))
        self.index = int(mesh.get_local_rank(d))
        self.next = dist.get_global_rank(self.group, (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(self.group, (self.index - 1) % self.size)

    def staged(self, tensor: torch.Tensor) -> bool:
        return staged(self.group, tensor)

    def shift(self, tensors: Sequence[torch.Tensor], forward: bool = True) -> "_Pending":
        """Send each tensor to the next rank (``forward``; else the previous)
        and receive the same shapes from the other side; returns a handle
        whose ``wait()`` gives the received tensors."""
        to, frm = (self.next, self.prev) if forward else (self.prev, self.next)
        host = bool(tensors) and self.staged(tensors[0])
        sends = [to_host(t) if host else t.contiguous() for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        ops = []
        for s, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, s, to, self.group))
            ops.append(dist.P2POp(dist.irecv, r, frm, self.group))
        works = dist.batch_isend_irecv(ops) if ops else []
        device = tensors[0].device if host else None
        return _Pending(works, recvs, sends, device)


class _Pending:
    """The transfers of one ``Ring.shift``; holds the send buffers until they
    complete, and copies host-staged receives back to ``device``."""

    def __init__(self, works, recvs, sends, device):
        self._works, self._recvs, self._sends, self._device = works, recvs, sends, device

    def wait(self) -> List[torch.Tensor]:
        for work in self._works:
            work.wait()
        if self._device is None:
            return self._recvs
        return [r.to(self._device) for r in self._recvs]


def _finish(o, l, m):
    """The normalized output and the rows' log-sum-exp of a finished
    ``(o, l, m)``; a row that attended nothing divides by 1 (``:119-121``)."""
    empty = l == 0.0
    out = o / torch.where(empty, 1.0, l)[..., None]
    lse = torch.where(empty, -torch.inf, m + torch.log(torch.where(empty, 1.0, l)))
    return out, lse


class _RingAttention(torch.autograd.Function):
    """Exact attention of local q against the K/V blocks of every rank of
    ``ring`` (``None``: this rank's block alone), B4 for each visited block.
    ``plain`` runs the plain versions whatever the device (comparisons)."""

    @staticmethod
    def forward(ctx, q, k, v, ring: Optional[Ring], causal: bool, scale: float, plain: bool):
        fwd = block_attention_fwd_reference if plain else block_attention_fwd
        size, index = (ring.size, ring.index) if ring is not None else (1, 0)
        qf, kf, vf = (x.float().contiguous() for x in (q, k, v))
        b, h, s_local, _ = qf.shape
        o = torch.zeros_like(qf)
        l = torch.zeros((b, h, s_local), dtype=torch.float32, device=qf.device)
        m = torch.full_like(l, -torch.inf)
        k_blk, v_blk = kf, vf
        for t in range(size):
            pending = ring.shift([k_blk, v_blk]) if t < size - 1 else None
            src = (index - t) % size
            if not causal or src <= index:  # a wholly future block is skipped
                fwd(qf, k_blk, v_blk, o, l, m, scale, causal, index * s_local, src * s_local)
            if pending is not None:
                k_blk, v_blk = pending.wait()
        out, lse = _finish(o, l, m)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.ring, ctx.causal, ctx.scale, ctx.plain = ring, causal, scale, plain
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        bwd = block_attention_bwd_reference if ctx.plain else block_attention_bwd
        delta_fn = attention_row_delta_reference if ctx.plain else attention_row_delta
        size, index = (ring.size, ring.index) if ring is not None else (1, 0)
        s_local = qf.shape[2]
        do = dout.float().contiguous()
        delta = delta_fn(out, do)
        dq = torch.zeros_like(qf)
        k_blk, v_blk = kf, vf
        dk_blk, dv_blk = torch.zeros_like(kf), torch.zeros_like(vf)
        for t in range(size):
            pending = ring.shift([k_blk, v_blk]) if t < size - 1 else None
            src = (index - t) % size
            if not causal or src <= index:
                bwd(qf, k_blk, v_blk, do, lse, delta, dq, dk_blk, dv_blk, scale, causal,
                    index * s_local, src * s_local)
            if size > 1:
                # the accumulators travel with their block; after the last
                # rotation each is back on the rank that owns the block
                dk_blk, dv_blk = ring.shift([dk_blk, dv_blk]).wait()
            if pending is not None:
                k_blk, v_blk = pending.wait()
        dtq, dtk, dtv = ctx.dtypes
        return dq.to(dtq), dk_blk.to(dtk), dv_blk.to(dtv), None, None, None, None


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
              plain: bool = False) -> torch.Tensor:
    """Exact softmax attention of local ``(B, H, S, D)`` tensors (one block
    of B4), differentiable; float32 inside, the output in q's dtype."""
    return _RingAttention.apply(q, k, v, None, bool(causal), _scale(q, scale), bool(plain))


def ring_attention(q, k, v, mesh, seq_dim: str = "seq", causal: bool = False,
                   scale: Optional[float] = None, plain: bool = False) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over the mesh dimension
    ``seq_dim`` (``:61 ring_attention_sharded``, ``:126 ring_attention``).

    q, k, v are this rank's local slices ``(B, H, S_local, D)``: the sequence
    sharded contiguously in mesh order over ``seq_dim`` (what the loader
    delivers for ``Shard(1)`` on that dimension), batch and heads as the
    caller holds them.  Differentiable; float32 inside (``:99-101``), the
    output in q's dtype.  ``plain=True`` runs the plain versions on any
    device (the comparison runs of ``chip_smoke.py`` and the card tests).
    """
    ring = Ring(mesh, seq_dim) if mesh is not None else None
    if ring is not None and ring.size == 1:
        ring = None
    return _RingAttention.apply(q, k, v, ring, bool(causal), _scale(q, scale), bool(plain))
