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

``device='cuda'`` is the default; ``device='cpu'`` runs the kernels' plain
versions (for tests).  Run ``python -m
petastorm_tpu_torch.examples.imagenet.train_resnet_cuda --help``.
"""

from __future__ import annotations

import argparse
import os
import queue
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from petastorm_tpu_torch import (CompressedImageCodec, Field, ScalarCodec, Schema, make_reader,
                                 write_dataset)
from petastorm_tpu_torch.cuda.loader import CudaDataLoader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.models import ResNet, ResNet50
from petastorm_tpu_torch.ops import draw_crop_boxes, draw_flips, normalize_images, random_resized_crop

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
    """

    def __init__(self, model: ResNet, num_classes: int, side: int,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.num_classes = num_classes
        self.side = side
        self.generator = generator
        for stat in model.batch_stats():
            stat.requires_grad_(True)
        self.leaves: List[torch.Tensor] = list(model.parameters()) + model.batch_stats()
        self.optimizer = torch.optim.SGD(self.leaves, lr=LR, momentum=MOMENTUM)
        self.last_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

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

    def update(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Loss of the model on normalized ``x``, backward, one SGD-momentum step."""
        loss = softmax_cross_entropy(self.model(x), labels, self.num_classes)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def __call__(self, images_u8: torch.Tensor, labels: torch.Tensor,
                 boxes: Optional[torch.Tensor] = None,
                 flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, h, w, _ = images_u8.shape
        if boxes is None:
            boxes = draw_crop_boxes(n, h, w, self.generator, device=images_u8.device)
        if flips is None:
            flips = draw_flips(n, self.generator, images_u8.device)
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
        gen = self.step.generator
        boxes, flips = [], []
        for _ in range(self.scan_steps):
            boxes.append(draw_crop_boxes(n, h, w, gen, device=device))
            flips.append(draw_flips(n, gen, device))
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


DECODES = ("host", "device")
INPUTS = ("petastorm", "tfdata")


def train(dataset_url: str, steps: int, global_batch: int, side: int,
          num_classes: int = 1000, decode: str = "device", workers: int = 4,
          prefetch: int = 2, device="cuda", scan_steps: int = 1,
          cache: str = "null", input_pipeline: str = "petastorm") -> Dict:
    """Run one warm-up unit and ``steps`` timed ResNet-50 training steps fed
    by the loader; returns samples/s, the input-wait share of the timed
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
    (``train_resnet_tpu.py:270-280``)."""
    if decode not in DECODES:
        raise ValueError(f"decode must be one of {DECODES}, got {decode!r}")
    if input_pipeline not in INPUTS:
        raise ValueError(f"input_pipeline must be one of {INPUTS}, got {input_pipeline!r}")
    if scan_steps < 1:
        raise ValueError("scan_steps must be >= 1")
    device = resolve_device(device)
    model = ResNet50(num_classes=num_classes, dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(0))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    step = TrainStep(model, num_classes, side,
                     generator=torch.Generator(device=device).manual_seed(AUGMENT_SEED))
    reader = None
    if input_pipeline == "tfdata":
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
        _sync(device)
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


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset-url", default=None)
    parser.add_argument("--rows", type=int, default=256)
    parser.add_argument("--side", type=int, default=224)
    parser.add_argument("--steps", type=int, default=8)
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
    args = parser.parse_args()
    url = args.dataset_url or tempfile.mkdtemp(prefix="imagenet_cuda_") + "/imagenet"
    if not args.skip_generate:
        generate_dataset(url, args.rows, args.side)
    m = train(url, args.steps, args.global_batch, args.side, num_classes=args.num_classes,
              decode=args.decode, workers=args.workers, prefetch=args.prefetch,
              device=args.device, scan_steps=args.scan_steps, cache=args.cache,
              input_pipeline=args.input)
    print(f"{m['steps'] * m['global_batch']} samples in {m['wall_s']:.2f}s"
          f" = {m['samples_per_sec']:.1f} samples/sec on {m['device_kind']} ({m['input']}, decode"
          f" {m['decode']}, cache {m['cache']}, {m['scan_steps']} steps a unit), input wait"
          f" {m['device_idle_pct']:.1f}% of the window, final loss {m['final_loss']:.4f}")
