"""ImageNet-style ResNet-50 training fed by the port, on one CUDA GPU.

Port of ``examples/imagenet/train_resnet_tpu.py`` (``generate_dataset``,
``build_tfrecord``, ``TfdataDeviceFeed`` and ``train``).  The
``input_pipeline='tfdata'`` comparator (``--input tfdata``) re-packs the
dataset's stored JPEGs as a TFRecord and feeds the same step from
``tf.data`` (``decode_jpeg`` on the host, a background copy to the card);
it needs tensorflow, imported only then, and raises ``ImportError``
without it.  The ``input_pipeline='petastorm'`` configuration runs with
``cache='null'``, ``'memory'`` or ``'local-disk'`` (the reader's
``cache_type``: epochs after the first skip the Parquet read and the host
half of the decode), with ``decode='device'`` (the default, as there) or
``decode='host'``: JPEG Parquet -> ``make_reader`` -> ``CudaDataLoader``
-> the training step of ``_step_math``.  ``scan_steps=K`` is the
counterpart of ``train_scan`` (``train_resnet_tpu.py:203-215``): the loader
delivers ``(K, batch, ...)`` stacks (``stack_batches=K``) and, on CUDA, K
whole steps are captured once in a ``torch.cuda.CUDAGraph`` and replayed
once per stack (:class:`ScanStep`).  With ``decode='host'`` the pool
workers decode the JPEGs and uint8 pixels go to the card; with
``decode='device'`` the workers run only the entropy decode, the coefficient
planes go to the card and kernel B2 finishes the decode there.  Unlike the
reference, ``decode='device'`` does not fall back to host decode when the
entropy library cannot be built: it raises.  The step:

1. random-resized-crop and horizontal flip in one launch of the resized-crop
   kernel (boxes and flips drawn from a ``torch.Generator`` seeded 17);
2. ``normalize_images`` (the normalize kernel), uint8 -> bf16;
3. ResNet-50, float32 leaves computing in bf16;
4. ``-(log_softmax(logits) * one_hot(label)).sum(-1).mean()``;
5. SGD with momentum 0.9 at lr 0.1 over every float32 leaf, the BatchNorm
   running ``mean``/``var`` included: the JAX step differentiates the whole
   variables dict and ``model.apply`` runs BatchNorm on the running
   statistics, so those leaves take gradient steps too.

Data parallelism (``train_resnet_tpu.py:171-176``, shardings ``:256-257``):
under ``torchrun --nproc-per-node N`` each rank owns one card and reads its
block of every global batch through ``cuda.loader.make_cuda_loader`` on
``parallel.mesh.data_parallel_mesh()`` (the reader sharded by the rank's
block).  The parameters are replicated: every rank builds them from seed 0,
and after each backward the gradients (and the loss) are averaged over the
mesh in one ``parallel.mesh.all_reduce_`` of a flat buffer, where XLA
inserted that collective itself; SGD-momentum then runs identically on every
rank.  BatchNorm runs on the running statistics, as in the reference, so
there are no batch statistics to synchronize.  Each rank draws the crop
boxes and flips of the whole global batch from the shared seed and keeps
its block's, so the ranks' draws together are one process's draws for the
global batch.  One rank (the default, no process group) is the one-card
trainer.  ``scan_steps=K`` with N > 1 captures the all-reduce in the CUDA
graph; that needs NCCL: over gloo (ranks sharing a card, collectives
staged through host memory) it raises, since a graph cannot capture a
host-staged collective.

``device='cuda'`` is the default; ``device='cpu'`` runs the kernels' plain
versions (for tests).  Run ``python -m
petastorm_tpu_torch.examples.imagenet.train_resnet_cuda --help``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from petastorm_tpu_torch import (CompressedImageCodec, Field, ScalarCodec, Schema, make_reader,
                                 write_dataset)
from petastorm_tpu_torch.cuda.loader import CudaDataLoader, make_cuda_loader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import ResNet, ResNet50
from petastorm_tpu_torch.ops import draw_crop_boxes, draw_flips, normalize_images, random_resized_crop
from petastorm_tpu_torch.parallel import mesh as mesh_ops

AUGMENT_SEED = 17
LR, MOMENTUM = 0.1, 0.9  # optax.sgd(0.1, momentum=0.9) of the JAX step


def imagenet_schema(side: int) -> Schema:
    return Schema("ImagenetLike", [
        Field("label", np.int64, (), ScalarCodec()),
        Field("image", np.uint8, (side, side, 3), CompressedImageCodec("jpeg", quality=90)),
    ])


def generate_dataset(url: str, rows: int, side: int, seed: int = 0) -> None:
    """``rows`` random labels in [0, 1000) and random uint8 images, JPEG q90."""
    rng = np.random.default_rng(seed)

    def row(_):
        label = int(rng.integers(0, 1000))
        return {"label": label, "image": rng.integers(0, 255, (side, side, 3)).astype(np.uint8)}

    write_dataset(url, imagenet_schema(side), (row(i) for i in range(rows)),
                  row_group_size_rows=max(rows // 8, 1), mode="overwrite")


def _tensorflow():
    """tensorflow, imported at the comparator's first use; a clear
    ``ImportError`` where it is not installed (no switch to petastorm)."""
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError("input_pipeline='tfdata' (--input tfdata) needs tensorflow, which is"
                          " not installed here; use input_pipeline='petastorm'") from exc
    return tf


def build_tfrecord(dataset_url: str, tfr_path: str) -> None:
    """The dataset's stored JPEG bytes and labels as one TFRecord of
    ``tf.train.Example`` records, in the order pyarrow lists the Parquet
    files and rows (``train_resnet_tpu.py:58-80``): tf.data's native format,
    the same bytes and the same decode work.  Written to a temporary name
    and renamed, so an interrupted build leaves no truncated file behind."""
    import pyarrow.dataset as pads

    tf = _tensorflow()
    table = pads.dataset(dataset_url, format="parquet").to_table(columns=["label", "image"])
    tmp_path = tfr_path + ".tmp"
    with tf.io.TFRecordWriter(tmp_path) as writer:
        for image, label in zip(table.column("image").to_pylist(),
                                table.column("label").to_pylist()):
            example = tf.train.Example(features=tf.train.Features(feature={
                "image": tf.train.Feature(bytes_list=tf.train.BytesList(value=[image])),
                "label": tf.train.Feature(int64_list=tf.train.Int64List(value=[int(label)]))}))
            writer.write(example.SerializeToString())
    os.replace(tmp_path, tfr_path)


class TfdataDeviceFeed:
    """The tf.data comparator (``train_resnet_tpu.py:83-160``): TFRecord ->
    ``decode_jpeg`` -> batch -> ``prefetch(AUTOTUNE)``, and a producer thread
    that copies each batch to ``device`` and waits for the copy, ``prefetch``
    batches ahead, so both pipelines overlap the copies with the step.

    ``next()`` gives ``{'image': uint8 (B, H, W, 3), 'label': int64 (B,)}``
    tensors on ``device``; ``consumer_wait_s`` sums the seconds the consumer
    waited for one.  The producer's failure is raised from ``next()``.
    """

    def __init__(self, tfr_path: str, global_batch: int, prefetch: int, device):
        tf = _tensorflow()
        feature = {"image": tf.io.FixedLenFeature([], tf.string),
                   "label": tf.io.FixedLenFeature([], tf.int64)}

        def parse(raw):
            example = tf.io.parse_single_example(raw, feature)
            return tf.io.decode_jpeg(example["image"], channels=3), example["label"]

        dataset = (tf.data.TFRecordDataset(tfr_path).repeat()
                   .map(parse, num_parallel_calls=tf.data.AUTOTUNE, deterministic=False)
                   .batch(global_batch, drop_remainder=True)
                   .prefetch(tf.data.AUTOTUNE))
        self._it = dataset.as_numpy_iterator()
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self.consumer_wait_s = 0.0
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="tfdata-device-feed")
        self._thread.start()

    def _put(self, value) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(value, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            while not self._stop.is_set():
                image, label = next(self._it)
                # tf.data hands out read-only arrays: a writable copy where needed
                batch = {"image": torch.from_numpy(np.require(image, requirements="W")),
                         "label": torch.from_numpy(np.require(label, requirements="W"))}
                if cuda:
                    with torch.cuda.stream(stream):
                        batch = {k: v.pin_memory().to(self._device, non_blocking=True)
                                 for k, v in batch.items()}
                    stream.synchronize()  # the copy completes on this thread
                self._put(batch)
        except BaseException as exc:  # noqa: BLE001 - raised again in __next__
            self._put(("__error__", exc))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        batch = self._q.get()
        self.consumer_wait_s += time.perf_counter() - t0
        if isinstance(batch, tuple):
            raise RuntimeError("tf.data feed producer failed") from batch[1]
        if self._device.type == "cuda":
            for tensor in batch.values():  # made on the producer's stream
                tensor.record_stream(torch.cuda.current_stream(self._device))
        return batch

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """``-(log_softmax(logits) * one_hot(labels)).sum(-1).mean()``; a label
    outside ``[0, num_classes)`` gives a zero one-hot row (as
    ``jax.nn.one_hot`` does) where ``F.cross_entropy`` would fail."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels[:, None] == classes).to(logits.dtype)
    return -(F.log_softmax(logits, dim=-1) * onehot).sum(-1).mean()


class TrainStep:
    """The training step of ``train_resnet_tpu.py::_step_math`` on ``model``.

    ``step(images_u8, labels)`` draws crop boxes and flips from ``generator``
    (on the images' device), runs augment -> normalize -> model -> loss ->
    SGD-momentum, and returns the loss (not synchronised).  ``boxes`` and
    ``flips`` may be passed instead, as :func:`random_resized_crop` takes them;
    ``last_draws`` holds the last step's.  ``state_dict()`` is the train state
    a checkpoint saves: the model's and the optimizer's state and the
    generator's.

    ``group`` (a ``torch.distributed`` group of several ranks, each holding
    the same leaves): the step is one rank's of a data-parallel step.  The
    rank's images are block ``block = (index, count)`` of the global batch;
    it draws the whole global batch's boxes and flips and keeps its block's,
    and after the backward it averages the gradients and the loss over
    ``group`` (one ``parallel.mesh.all_reduce_`` of a flat buffer) before the
    SGD step.  ``reduce_ms()`` gives the all-reduce's mean time a step.
    """

    def __init__(self, model: ResNet, num_classes: int, side: int,
                 generator: Optional[torch.Generator] = None, group=None,
                 block: Tuple[int, int] = (0, 1)):
        self.model = model
        self.num_classes = num_classes
        self.side = side
        self.generator = generator
        for stat in model.batch_stats():
            stat.requires_grad_(True)
        self.leaves: List[torch.Tensor] = list(model.parameters()) + model.batch_stats()
        self.optimizer = torch.optim.SGD(self.leaves, lr=LR, momentum=MOMENTUM)
        self.last_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.block = block
        self._reduce_events: List[Tuple[object, object]] = []
        self._reduce_host_s: List[float] = []

    def state_dict(self) -> Dict:
        """The model's and optimizer's ``state_dict()`` and the generator's
        state (None without a generator)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "generator": None if self.generator is None else self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s train state (the leaves in place)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.generator is not None and state.get("generator") is not None:
            self.generator.set_state(state["generator"])

    def momentum(self) -> List[Optional[torch.Tensor]]:
        """Each leaf's momentum buffer (None before the first step)."""
        return [self.optimizer.state.get(leaf, {}).get("momentum_buffer")
                for leaf in self.leaves]

    def draw(self, n: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``n`` crop boxes and flips: its block of the draws of
        the global batch (``n * count`` rows), boxes first, then flips."""
        index, count = self.block
        boxes = draw_crop_boxes(n * count, h, w, self.generator, device=device)
        flips = draw_flips(n * count, self.generator, device)
        return boxes[index * n:(index + 1) * n], flips[index * n:(index + 1) * n]

    def update(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Loss of the model on normalized ``x``, backward, one SGD-momentum
        step; on a data-parallel group the gradients and the loss are first
        averaged over the ranks."""
        loss = softmax_cross_entropy(self.model(x), labels, self.num_classes)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if self.world > 1:
            loss = self._average(loss)
        self.optimizer.step()
        return loss

    def _average(self, loss: torch.Tensor) -> torch.Tensor:
        """Average every leaf's gradient and the loss over the group in one
        all-reduce of a flat buffer; returns the global mean loss."""
        grads = [leaf.grad for leaf in self.leaves]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
        timed = flat.is_cuda and not torch.cuda.is_current_stream_capturing()
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        mesh_ops.all_reduce_(flat, self.group)
        if timed:
            end.record()
            self._reduce_events.append((start, end))
        elif not flat.is_cuda:
            self._reduce_host_s.append(time.perf_counter() - t0)
        flat.div_(self.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[-1].clone()

    def reduce_ms(self) -> Optional[float]:
        """Mean all-reduce time a step over the eager steps since the last
        call (CUDA events on the card, the host clock on the CPU); None when
        there was none (one rank, or only replays of a captured graph)."""
        if self._reduce_events:
            self._reduce_events[-1][1].synchronize()
            times = [a.elapsed_time(b) for a, b in self._reduce_events]
        else:
            times = [1e3 * t for t in self._reduce_host_s]
        self._reduce_events, self._reduce_host_s = [], []
        return sum(times) / len(times) if times else None

    def __call__(self, images_u8: torch.Tensor, labels: torch.Tensor,
                 boxes: Optional[torch.Tensor] = None,
                 flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, h, w, _ = images_u8.shape
        index, count = self.block
        rows = slice(index * n, (index + 1) * n)
        if boxes is None:
            boxes = draw_crop_boxes(n * count, h, w, self.generator, device=images_u8.device)[rows]
        if flips is None:
            flips = draw_flips(n * count, self.generator, images_u8.device)[rows]
        self.last_draws = (boxes, flips)
        # crop + flip in one resized-crop launch on the card, then normalize to bf16
        crops = random_resized_crop(images_u8, None, (self.side, self.side), boxes=boxes,
                                    flips=flips)
        return self.update(normalize_images(crops), labels)


class ScanStep:
    """K training steps of ``step`` per call: the counterpart of the JAX
    trainer's ``train_scan`` (``lax.scan`` over K steps in one dispatch).

    ``scan(images, labels)`` takes a ``(K, B, H, W, 3)`` uint8 stack and
    ``(K, B)`` labels and returns the K losses as a ``(K,)`` tensor.  It
    first draws the K steps' crop boxes and flips from ``step.generator``,
    eagerly and in the eager loop's order (boxes, then flips, per step), so
    they equal K calls of ``step`` bit for bit; ``boxes`` (K, B, 4) and
    ``flips`` (K, B) may be passed instead.

    On CUDA the first call runs its stack as K eager steps on a side stream
    (SGD makes its momentum buffers, cuDNN picks its algorithms and the
    kernels are built), the first step under ``FlopCounterMode``
    (``flops_per_step``), and then captures K whole steps (crop + flip,
    normalize, forward, backward, SGD-momentum) in one ``torch.cuda.CUDAGraph``
    over static input, draw and loss buffers.  Every later call copies its
    stack and draws into those buffers and replays the graph once.  A failed
    capture raises; there is no eager fallback.  On the CPU every call runs
    the K steps eagerly.  ``last_draws`` holds the last unit's (boxes,
    flips); ``replays`` counts replays; the kernels' launch counters count
    the captured launches once, at capture.
    """

    def __init__(self, step: TrainStep, scan_steps: int):
        if scan_steps < 1:
            raise ValueError("scan_steps must be >= 1")
        self.step = step
        self.scan_steps = scan_steps
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.flops_per_step: Optional[int] = None
        self.replays = 0
        self.last_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._losses: Optional[torch.Tensor] = None

    def draw(self, n: int, h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """K steps' (boxes, flips), drawn as K eager steps draw them."""
        boxes, flips = [], []
        for _ in range(self.scan_steps):
            b, f = self.step.draw(n, h, w, device)
            boxes.append(b)
            flips.append(f)
        return torch.stack(boxes), torch.stack(flips)

    def eager(self, images: torch.Tensor, labels: torch.Tensor, boxes: torch.Tensor,
              flips: torch.Tensor) -> torch.Tensor:
        """The K steps one after the other, as K calls of ``step``."""
        losses = []
        for k in range(self.scan_steps):
            if k == 0 and self.flops_per_step is None:
                self.flops_per_step, loss = count_flops(self.step, images[0], labels[0],
                                                        boxes[0], flips[0])
            else:
                loss = self.step(images[k], labels[k], boxes=boxes[k], flips=flips[k])
            losses.append(loss)
        return torch.stack(losses)

    def __call__(self, images: torch.Tensor, labels: torch.Tensor,
                 boxes: Optional[torch.Tensor] = None,
                 flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, n, h, w, _ = images.shape
        if k != self.scan_steps:
            raise ValueError(f"a stack of {self.scan_steps} steps was expected, got {k}")
        if boxes is None:
            boxes, flips = self.draw(n, h, w, images.device)
        self.last_draws = (boxes, flips)
        if images.device.type != "cuda":
            return self.eager(images, labels, boxes, flips)
        if self.graph is None:
            return self._warm_up_and_capture(images, labels, boxes, flips)
        for name, value in (("images", images), ("labels", labels), ("boxes", boxes),
                            ("flips", flips)):
            self._static[name].copy_(value)
        self.graph.replay()
        self.replays += 1
        return self._losses.clone()

    def _warm_up_and_capture(self, images, labels, boxes, flips) -> torch.Tensor:
        """Run the first stack eagerly on a side stream, then capture the graph."""
        device = images.device
        self._static = {"images": images.clone(), "labels": labels.clone(),
                        "boxes": boxes.clone(), "flips": flips.clone()}
        static = self._static
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            losses = self.eager(static["images"], static["labels"], static["boxes"],
                                static["flips"])
        torch.cuda.current_stream(device).wait_stream(side)
        self.step.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads keep copying and decoding meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._losses = torch.stack([
                self.step(static["images"][i], static["labels"][i], boxes=static["boxes"][i],
                          flips=static["flips"][i]) for i in range(self.scan_steps)])
        self.graph = graph
        return losses


def count_flops(fn, *args) -> Tuple[int, object]:
    """Run ``fn(*args)`` once under ``FlopCounterMode``; returns (flops, result).

    It counts the matrix products and convolutions of the forward and the
    backward pass (2 flops per multiply-add) and nothing else: not the
    elementwise ops (BatchNorm, ReLU, loss, SGD update) and not the
    augment and normalize kernels, which it cannot see."""
    with FlopCounterMode(display=False) as counter:
        result = fn(*args)
    return counter.get_total_flops(), result


def measure_peak_flops(device) -> Optional[float]:
    """Achievable bf16 matmul rate of the card, in flop/s; None off a GPU.

    Chained 4096 x 4096 bf16 matmuls at two chain lengths, each timed by CUDA
    events, interleaved three times and the minimum kept; the difference of
    the two divided by the difference of the lengths is the time of one
    matmul without the fixed launch cost.  2 * 4096^3 flops per matmul.  The
    right factor is scaled by 1/sqrt(4096) so the chain's values neither
    grow nor vanish."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    n, lo, hi = 4096, 32, 128
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn(n, n, generator=gen, device=device) * n ** -0.5).to(torch.bfloat16)

    def chain(iters):
        c = a
        for _ in range(iters):
            c = c @ b
        return c

    for iters in (lo, hi):
        chain(iters)
    best = {lo: float("inf"), hi: float("inf")}
    for _ in range(3):
        for iters in (lo, hi):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(iters)
            end.record()
            end.synchronize()
            best[iters] = min(best[iters], start.elapsed_time(end) / 1e3)
    slope = (best[hi] - best[lo]) / (hi - lo)
    return 2 * n ** 3 / slope if slope > 0 else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save_first_step(path: str, step: TrainStep, first: Dict, loss: torch.Tensor, group,
                     world: int) -> None:
    """Rank 0 saves the first step's global batch, every rank's draws (rank
    order) and the leaves after the step (see :func:`train`)."""
    boxes, flips = step.last_draws
    record = {"images": first["image"], "labels": first["label"], "boxes": boxes,
              "flips": flips.to(torch.uint8)}
    if world > 1:
        record = {k: mesh_ops.gather_blocks(v, group) for k, v in record.items()}
    record = {k: v.cpu() for k, v in record.items()}
    record["flips"] = record["flips"].bool()
    if world == 1 or dist.get_rank() == 0:
        record["leaves"] = [leaf.detach().cpu().clone() for leaf in step.leaves]
        record["loss"] = float(loss)
        torch.save(record, path)


DECODES = ("host", "device")
INPUTS = ("petastorm", "tfdata")


def kernel_launches() -> Dict[str, int]:
    """This process's launch counts of the step's kernels: B1 (normalize),
    B3 (the tiled resized crop) and B2 (the tiled JPEG decode)."""
    from petastorm_tpu_torch.ops import augment, jpeg, normalize

    return {"normalize_u8": normalize.normalize_kernel.launches,
            "resized_crop_flip_u8": augment.resized_crop_kernel.launches_tiled,
            "jpeg_decode_u8": jpeg.jpeg_decode_kernel.launches_tiled}


def leaves_digest(step: TrainStep) -> str:
    """sha256 over every leaf's float32 bytes, in ``step.leaves`` order."""
    h = hashlib.sha256()
    for leaf in step.leaves:
        h.update(leaf.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _probe_allreduce_ms(step: TrainStep, reps: int = 5) -> float:
    """Mean time of the step's all-reduce (a flat buffer as large as the
    leaves and the loss) run alone, for a captured step that cannot be timed
    inside its graph."""
    device = step.leaves[0].device
    flat = torch.zeros(sum(leaf.numel() for leaf in step.leaves) + 1, device=device)
    mesh_ops.all_reduce_(flat, step.group)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mesh_ops.all_reduce_(flat, step.group)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            mesh_ops.all_reduce_(flat, step.group)
            times.append(1e3 * (time.perf_counter() - t0))
    return sum(times) / len(times)


def train(dataset_url: str, steps: int, global_batch: int, side: int,
          num_classes: int = 1000, decode: str = "device", workers: int = 4,
          prefetch: int = 2, device="cuda", scan_steps: int = 1,
          cache: str = "null", input_pipeline: str = "petastorm",
          first_step_path: Optional[str] = None, warmup: int = 1) -> Dict:
    """Run ``warmup`` warm-up units (one by default) and ``steps`` timed
    ResNet-50 training steps fed by the loader; returns samples/s, the input-wait share of the timed
    window (``device_idle_pct``), the stall against a rerun of as many units
    on one resident unit (``input_stall_pct``), and the model FLOP counts.
    ``decode``: ``'device'`` (hybrid JPEG decode, kernel B2) or ``'host'``.
    ``cache``: the reader's ``cache_type`` (``train_resnet_tpu.py:244-249``);
    with ``decode='device'`` it holds the coefficient planes, and B2 still
    runs every step.
    ``scan_steps=K``: a unit is a stack of K batches run by :class:`ScanStep`
    (a CUDA graph of K steps on the card); ``steps`` rounds up to whole units
    and ``flops_per_sample`` comes from a single eager step of the warm-up
    (``train_resnet_tpu.py:386-391``).
    ``input_pipeline='tfdata'``: the same stored JPEGs through
    :class:`TfdataDeviceFeed` into the same step (``decode`` and ``cache``
    do not apply; the result says ``decode='tfdata-host'``); under
    ``scan_steps=K`` each unit stacks K tf.data batches on the card
    (``train_resnet_tpu.py:270-280``).

    In an initialized process group of N > 1 ranks the step is data
    parallel (see the module docstring): ``global_batch`` is split over the
    ranks, the report adds ``world_size``, ``transport``,
    ``samples_per_sec_per_gpu``, ``allreduce_ms`` (the gradient
    all-reduce's mean time a step: CUDA events around it in eager steps, a
    probe of the same buffer alone under ``scan_steps > 1``) and
    ``params_digest`` (:func:`leaves_digest` after the last step).
    ``first_step_path``: rank 0 saves there (``torch.save``) the first
    step's global batch (images, labels), its crop boxes and flips (every
    rank's, in rank order) and the leaves after it, for a one-process
    recomputation; ``scan_steps=1`` only.  ``launches`` counts this
    process's launches of B1, B3 (tiled) and B2 (tiled) over the whole run."""
    if decode not in DECODES:
        raise ValueError(f"decode must be one of {DECODES}, got {decode!r}")
    if input_pipeline not in INPUTS:
        raise ValueError(f"input_pipeline must be one of {INPUTS}, got {input_pipeline!r}")
    if scan_steps < 1:
        raise ValueError("scan_steps must be >= 1")
    if first_step_path is not None and scan_steps != 1:
        raise ValueError("first_step_path records a single step: use scan_steps=1")
    if warmup < 1:
        raise ValueError("warmup must be >= 1 (the first unit sets up cuDNN and the graph)")
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    mesh = group = transport = None
    block = (0, 1)
    if world > 1:
        from torch.distributed.tensor import Shard

        if input_pipeline != "petastorm":
            raise ValueError("input_pipeline='tfdata' runs on one rank; the data-parallel"
                             " trainer reads through the petastorm loader")
        if global_batch % world:
            raise ValueError(f"global_batch {global_batch} does not divide over {world} ranks")
        backend = dist.get_backend()
        mesh = mesh_ops.data_parallel_mesh(device_type="cuda" if backend == "nccl" else "cpu")
        group = mesh_ops.mesh_group(mesh)
        transport = mesh_ops.transport_name(group, device)
        if scan_steps > 1 and device.type == "cuda" and backend != "nccl":
            raise ValueError(
                f"scan_steps={scan_steps} over {world} ranks captures the gradient all-reduce"
                f" in a CUDA graph, which needs NCCL; the transport here is {transport!r}"
                " (ranks sharing a card stage collectives through host memory, which a"
                " graph cannot capture). Give each rank its own card, or use scan_steps=1")
        block = mesh_ops.batch_block(mesh, (Shard(0),))
    model = ResNet50(num_classes=num_classes, dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(0))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    step = TrainStep(model, num_classes, side,
                     generator=torch.Generator(device=device).manual_seed(AUGMENT_SEED),
                     group=group, block=block)
    reader = None
    if world > 1:
        feed = make_cuda_loader(dataset_url, global_batch, mesh=mesh,
                                shardings={"image": (Shard(0),), "label": (Shard(0),)},
                                reader_factory=make_reader, num_epochs=None,
                                workers_count=workers, decode_placement={"image": decode},
                                cache_type=cache, device=device, prefetch=prefetch,
                                stack_batches=scan_steps)
        reader = feed._reader
    elif input_pipeline == "tfdata":
        tfr = dataset_url.rstrip("/") + ".tfrecord"
        if not os.path.exists(tfr):
            build_tfrecord(dataset_url, tfr)
        feed = TfdataDeviceFeed(tfr, global_batch, prefetch, device)
        decode = "tfdata-host"
    else:
        reader = make_reader(dataset_url, num_epochs=None, workers_count=workers,
                             decode_placement={"image": decode}, cache_type=cache)
        feed = CudaDataLoader(reader, batch_size=global_batch, device=device,
                              prefetch=prefetch, stack_batches=scan_steps)
    if scan_steps > 1:
        scan = ScanStep(step, scan_steps)
        run_unit = lambda unit: scan(unit["image"], unit["label"])[-1]  # noqa: E731
    else:
        run_unit = lambda unit: step(unit["image"], unit["label"])  # noqa: E731

    def consumer_wait() -> float:
        return (feed.consumer_wait_s if reader is None
                else feed.diagnostics()["consumer_wait_s"])

    with feed:
        it = iter(feed)

        def pull_unit():
            if scan_steps <= 1 or reader is not None:
                return next(it)  # the loader stacks K batches itself (stack_batches=K)
            # tf.data has no stacked delivery: K batches and a stack on the card
            batches = [next(it) for _ in range(scan_steps)]
            return {name: torch.stack([b[name] for b in batches]) for name in ("image", "label")}

        first = pull_unit()
        # warm-up (cuDNN set-up, kernel builds, the graph's capture), and the
        # FLOP count of one eager step
        if scan_steps > 1:
            loss = run_unit(first)
            flops_per_step = scan.flops_per_step
        else:
            flops_per_step, loss = count_flops(step, first["image"], first["label"])
        if first_step_path is not None:
            _save_first_step(first_step_path, step, first, loss, group, world)
        for _ in range(warmup - 1):
            loss = run_unit(pull_unit())
        _sync(device)
        step.reduce_ms()  # the warm-up's all-reduce is not the timed one
        wait0 = consumer_wait()
        done, units = 0, 0
        t0 = time.perf_counter()
        while done < steps:
            loss = run_unit(pull_unit())
            done += scan_steps
            units += 1
        _sync(device)
        dt = time.perf_counter() - t0
        input_wait_s = consumer_wait() - wait0
        allreduce_ms = step.reduce_ms() if world > 1 else None
        if world > 1 and allreduce_ms is None:
            allreduce_ms = _probe_allreduce_ms(step)
        # compute floor: as many units on one resident unit, no input inside the loop
        resident = pull_unit()
        t1 = time.perf_counter()
        for _ in range(units):
            run_unit(resident)
        _sync(device)
        compute_dt = time.perf_counter() - t1
        diagnostics = feed.diagnostics() if reader is not None else {}
    return {
        "samples_per_sec": done * global_batch / dt,
        "samples_per_sec_per_gpu": done * global_batch / dt / world,
        "world_size": world,
        "transport": transport,
        "allreduce_ms": allreduce_ms,
        "params_digest": leaves_digest(step),
        "launches": kernel_launches(),
        "device_idle_pct": 100.0 * input_wait_s / dt,
        "input_stall_pct": 100.0 * max(0.0, dt - compute_dt) / dt,
        "compute_floor_wall_s": compute_dt,
        "flops_per_sample": flops_per_step / global_batch,
        "measured_peak_flops": measure_peak_flops(device),
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "steps": done,
        "scan_steps": scan_steps,
        "global_batch": global_batch,
        "decode": decode,
        "input": input_pipeline,
        "cache": cache,
        "cache_stats": reader.cache_stats() if reader is not None else None,
        "wall_s": dt,
        "final_loss": float(loss),
        "diagnostics": diagnostics,
    }


def _init_from_env(device: str) -> torch.device:
    """Under torchrun with WORLD_SIZE > 1: initialize the process group and
    pick this rank's device (NCCL when the ranks have distinct cards, gloo
    when they share one or run on the host); the device alone otherwise."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return resolve_device(device)
    rank = int(os.environ["RANK"])
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
        dev, backend = torch.device(device), "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset-url", default=None)
    parser.add_argument("--rows", type=int, default=256)
    parser.add_argument("--side", type=int, default=224)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=1, help="warm-up units before the timing")
    parser.add_argument("--global-batch", type=int, default=32)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--prefetch", type=int, default=2)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--decode", choices=DECODES, default="device",
                        help="where the JPEG decode finishes (default: device, kernel B2)")
    parser.add_argument("--cache", choices=("null", "memory", "local-disk"), default="null",
                        help="the reader's cache_type: warm epochs skip the Parquet read and"
                             " the host decode")
    parser.add_argument("--input", choices=INPUTS, default="petastorm",
                        help="tfdata = the comparator: the same JPEGs as a TFRecord through"
                             " tf.data into the same step (needs tensorflow)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scan-steps", type=int, default=1,
                        help="training steps per unit: a CUDA graph of K steps replayed per"
                             " stacked unit (stack_batches=K)")
    parser.add_argument("--skip-generate", action="store_true",
                        help="dataset-url already holds the dataset")
    parser.add_argument("--first-step", default=None,
                        help="rank 0 saves the first step's batch, draws and leaves here")
    parser.add_argument("--report", default=None,
                        help="write this rank's report as JSON to <report>.<rank>.json")
    args = parser.parse_args(argv)
    device = _init_from_env(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        url = args.dataset_url
        if url is None:
            port = os.environ.get("MASTER_PORT", str(os.getpid()))
            url = os.path.join(tempfile.gettempdir(), f"imagenet_cuda_{port}", "imagenet")
        if not args.skip_generate and rank == 0:
            generate_dataset(url, args.rows, args.side)
        if world > 1:
            dist.barrier()
        m = train(url, args.steps, args.global_batch, args.side, num_classes=args.num_classes,
                  decode=args.decode, workers=args.workers, prefetch=args.prefetch,
                  device=device, scan_steps=args.scan_steps, cache=args.cache,
                  input_pipeline=args.input, first_step_path=args.first_step,
                  warmup=args.warmup)
        if args.report:
            out = {k: v for k, v in m.items() if k != "diagnostics"}
            with open(f"{args.report}.{rank}.json", "w") as f:
                json.dump(out, f, default=str)
        if rank == 0:
            print(f"{m['steps'] * m['global_batch']} samples in {m['wall_s']:.2f}s"
                  f" = {m['samples_per_sec']:.1f} samples/sec on {m['device_kind']}"
                  f" ({m['samples_per_sec_per_gpu']:.1f} a GPU over {world} rank(s)"
                  + (f", {m['transport']}, all-reduce {m['allreduce_ms']:.2f} ms a step"
                     if world > 1 else "")
                  + f"; {m['input']}, decode {m['decode']}, cache {m['cache']},"
                  f" {m['scan_steps']} steps a unit), input wait"
                  f" {m['device_idle_pct']:.1f}% of the window, final loss"
                  f" {m['final_loss']:.4f}")
        if world > 1:
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
