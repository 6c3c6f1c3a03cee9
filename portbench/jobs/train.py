"""The training consumer: the port's ImageNet training step on the feed.

Set-up builds one ``TrainStep`` over the port's ``ResNet50`` (bf16
compute, float32 leaves) with the benchmark's weights, and drives it
through its first ``CHECK_STEPS`` steps with the window's own call and feed,
then ``WARM_STEPS`` more; the window goes on with the same object.  Each
step draws its crop boxes on the card from the run's seed, RandomResizedCrop's
formula inside each row's own ``height`` x ``width`` (area scale and
log-ratio from the configuration), and a flip a row, and passes them to the
step, which crops, flips, normalizes and trains in one call.

Of the first steps it keeps what the reference follows: the rows' ids,
boxes and flips, the losses, each leaf's momentum buffer norm after step 1
(SGD's first buffer is the gradient) and each leaf's change after step
``CHECK_STEPS``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import check, roofline
from portbench.feed import Context, FeedJob
from portbench.reference import resnet as ref_resnet
from portbench.reference import steps as ref_steps

CHECK_STEPS = 3
WARM_STEPS = 2


def draw_boxes(heights: torch.Tensor, widths: torch.Tensor, crop: Dict,
               generator: torch.Generator):
    """(N, 4) float32 boxes ``(y0, x0, crop_h, crop_w)`` inside each row's
    own size and (N,) bool flips, from ``generator`` on the rows' device."""
    n = heights.shape[0]
    u = torch.rand((5, n), generator=generator, device=heights.device)
    h, w = heights.float(), widths.float()
    lo, hi = crop["scale"]
    area = (lo + (hi - lo) * u[0]) * (h * w)
    log_lo, log_hi = math.log(crop["ratio"][0]), math.log(crop["ratio"][1])
    ratio = torch.exp(log_lo + (log_hi - log_lo) * u[1])
    crop_w = torch.minimum(torch.clamp_min(torch.sqrt(area * ratio), 1.0), w)
    crop_h = torch.minimum(torch.clamp_min(torch.sqrt(area / ratio), 1.0), h)
    boxes = torch.stack([u[2] * (h - crop_h), u[3] * (w - crop_w), crop_h, crop_w], dim=1)
    return boxes, u[4] < crop.get("flip", 0.5)


class Job(FeedJob):
    kind = "train"
    rate_metric = "train_samples_per_s"
    trace_units = 24
    antialias = False

    def __init__(self, ctx: Context):
        super().__init__(ctx)
        self.flips: List[torch.Tensor] = []    # each step's flips since forget()

    # -- the program ------------------------------------------------------

    def setup(self) -> None:
        from petastorm_tpu_torch.examples.imagenet.train_resnet_cuda import TrainStep
        from petastorm_tpu_torch.models import ResNet50

        ctx, config = self.ctx, self.config
        device = torch.device(ctx.device)
        self.start_feed()
        model = ResNet50(num_classes=int(config["num_classes"]), dtype=torch.bfloat16,
                         device=device)
        leaves = ref_resnet.make_leaves(ctx.seed_for("weights"), device,
                                        int(config["num_classes"]))
        model.load_state_dict(leaves)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.step = TrainStep(model, int(config["num_classes"]), int(config["image_side"]))
        names = {id(t): n for n, t in model.state_dict(keep_vars=True).items()}
        self.names = [names[id(leaf)] for leaf in self.step.leaves]
        self.generator = torch.Generator(device=device).manual_seed(ctx.seed_for("crops"))
        start = [leaf.detach().clone() for leaf in self.step.leaves]
        losses = []
        for k in range(CHECK_STEPS):
            losses.append(self._step())
            if k == 0:
                grad1 = torch.stack([b.detach().double().norm() for b in self.step.momentum()])
        delta = torch.stack([(leaf.detach().double() - s.double()).norm()
                             for leaf, s in zip(self.step.leaves, start)])
        del start
        self.first = {"losses": torch.stack(losses), "grad1": grad1, "delta": delta,
                      "ids": self.pulled[:CHECK_STEPS], "boxes": self.boxes[:CHECK_STEPS],
                      "flips": self.flips[:CHECK_STEPS]}
        for _ in range(WARM_STEPS):
            self._step()

    def _step(self) -> torch.Tensor:
        batch = self._next()
        boxes, flips = draw_boxes(batch["height"], batch["width"], self.config["crop"],
                                  self.generator)
        self.boxes.append(boxes)
        self.flips.append(flips)
        return self.step(batch["image"], batch["label"], boxes=boxes, flips=flips)

    def unit(self) -> int:
        self._step()
        return self.batch

    def forget(self) -> None:
        super().forget()
        self.flips = []

    def close(self) -> None:
        self.first = {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                      for k, v in self.first.items()}
        self.stop_feed()
        del self.step
        self.flips = []

    # -- the yardstick ----------------------------------------------------------

    def flops_per_sample(self) -> float:
        return roofline.resnet50_train_flops(int(self.config["image_side"]),
                                             int(self.config["num_classes"]))

    # -- the check ------------------------------------------------------------

    def program_numbers(self) -> Dict:
        first = self.first
        return {"losses": [float(x) for x in first["losses"]],
                "grad1": dict(zip(self.names, first["grad1"].tolist())),
                "delta": dict(zip(self.names, first["delta"].tolist()))}

    def reference_numbers(self, quantize=None) -> Dict:
        ctx, config = self.ctx, self.config
        device = torch.device(ctx.device)
        corpus = ctx.corpus
        batches = []
        for ids, boxes, flips in zip(self.first["ids"], self.first["boxes"],
                                     self.first["flips"]):
            ids = ids.numpy()
            x = ref_steps.images([corpus.streams[i] for i in ids], boxes, flips, config,
                                 antialias=False, device=device)
            batches.append((x, torch.from_numpy(corpus.labels[ids]).to(device)))
        leaves = ref_resnet.make_leaves(ctx.seed_for("weights"), device,
                                        int(config["num_classes"]))
        opt = config["optimizer"]
        return ref_steps.train_steps(leaves, batches, opt["lr"], opt["momentum"], quantize)

    def compare(self, program: Dict, reference: Dict) -> Dict[str, Dict]:
        return check.train_numbers(program, reference)

    def unanswered(self) -> int:
        return 0
