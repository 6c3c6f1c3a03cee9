"""The evaluation consumer: the port's crop, normalize and ResNet-50 forward
on the feed.

Each batch: one antialiased resized-crop launch of the port
(``random_resized_crop(..., antialias=True)``) with an explicit box a row,
the centered square of side ``image_side / resize_side`` of the row's
shorter side (the MLPerf preprocessing, resize the shorter side to 256 and
center-crop 224, as one resample), then ``normalize_images`` to bf16 and
the model's forward under ``torch.inference_mode()``.

The answers checked are the logits of a sample of rows drawn from the seed:
each batch writes its rows' logits into a table on the card, one row a
sampled row and one row for every other, so the window keeps the last
answer of each sampled row without a copy to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import check, roofline
from portbench.feed import FeedJob
from portbench.reference import resnet as ref_resnet
from portbench.reference import steps as ref_steps

WARM_BATCHES = 3


def center_boxes(heights: torch.Tensor, widths: torch.Tensor, image_side: int,
                 resize_side: int) -> torch.Tensor:
    """(N, 4) float32 boxes: the centered square of side ``image_side /
    resize_side`` of each row's shorter side."""
    h, w = heights.float(), widths.float()
    side = torch.minimum(h, w) * (image_side / resize_side)
    return torch.stack([(h - side) / 2, (w - side) / 2, side, side], dim=1)


class Job(FeedJob):
    kind = "eval"
    rate_metric = "eval_samples_per_s"
    trace_units = 48
    antialias = True

    # -- the program ------------------------------------------------------

    def setup(self) -> None:
        from petastorm_tpu_torch.models import ResNet50

        ctx, config = self.ctx, self.config
        device = torch.device(ctx.device)
        self.start_feed()
        classes = int(config["num_classes"])
        model = ResNet50(num_classes=classes, dtype=torch.bfloat16, device=device)
        model.load_state_dict(ref_resnet.make_leaves(ctx.seed_for("weights"), device, classes))
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model.eval()
        rows = ctx.corpus.rows
        rng = np.random.default_rng(ctx.seed_for("sample"))
        self.sample = np.sort(rng.choice(rows, int(config["sample_rows"]), replace=False))
        slot = np.full(rows, len(self.sample), np.int64)
        slot[self.sample] = np.arange(len(self.sample))
        self.slot = torch.from_numpy(slot).to(device)
        self.answers = torch.full((len(self.sample) + 1, classes), float("nan"), device=device)
        for _ in range(WARM_BATCHES):
            self.unit()

    def unit(self) -> int:
        from petastorm_tpu_torch.ops import normalize_images, random_resized_crop

        config = self.config
        side = int(config["image_side"])
        batch = self._next()
        boxes = center_boxes(batch["height"], batch["width"], side, int(config["resize_side"]))
        self.boxes.append(boxes)
        norm = config["normalize"]
        with torch.inference_mode():
            crops = random_resized_crop(batch["image"], None, (side, side), antialias=True,
                                        boxes=boxes)
            logits = self.model(normalize_images(crops, norm["mean"], norm["std"]))
            self.answers.index_copy_(0, self.slot[batch["row_id"]], logits)
        return self.batch

    def close(self) -> None:
        self.answers = self.answers[:-1].cpu().numpy()
        self.stop_feed()
        del self.model, self.slot

    # -- the yardstick ----------------------------------------------------------

    def flops_per_sample(self) -> float:
        return roofline.resnet50_forward_flops(int(self.config["image_side"]),
                                               int(self.config["num_classes"]))

    # -- the check ------------------------------------------------------------

    def unanswered(self) -> int:
        """Sampled rows the window gave no answer for."""
        return int(np.isnan(self.answers).any(axis=1).sum())

    def program_numbers(self) -> Dict:
        return {"logits": self.answers}

    def reference_numbers(self, quantize=None) -> Dict:
        ctx, config = self.ctx, self.config
        device = torch.device(ctx.device)
        corpus = ctx.corpus
        side = int(config["image_side"])
        boxes = center_boxes(torch.from_numpy(corpus.heights[self.sample]),
                             torch.from_numpy(corpus.widths[self.sample]), side,
                             int(config["resize_side"]))
        x = ref_steps.images([corpus.streams[i] for i in self.sample], boxes, None, config,
                             antialias=True, device=device)
        leaves = ref_resnet.make_leaves(ctx.seed_for("weights"), device,
                                        int(config["num_classes"]))
        return {"logits": ref_steps.eval_logits(leaves, x, quantize).cpu().numpy()}

    def compare(self, program: Dict, reference: Dict) -> Dict[str, Dict]:
        got = program["logits"]
        answered = ~np.isnan(got).any(axis=1)
        if not answered.any():
            return {"logit_gap": {"value": float("inf"), "rows": 0}}
        return {"logit_gap": {"value": check.logit_gap(got[answered],
                                                       reference["logits"][answered]),
                              "rows": int(answered.sum())}}
