"""Readings for the limits of ``correct``: the control and the planted faults.

    python3 -m portbench.controls --workload <cell> --seeds <n> ... [--fault <name>]
        [--seconds <s>]

Each seed is one run of the cell (``run.run_cell``) with a short window.
It prints, per seed, the sound program's numbers and the control's: the
reference with its products in float8 (``reference.resnet.Fp8``: e4m3
operands, e5m2 output gradients, a scale a tensor), put in the program's
place (the precision under the bfloat16 the configuration states).  With
``--fault``, the program runs with a fault planted underneath, and the
numbers printed are the faulty program's:

- ``half_batch``: the training step computes its loss, and so its
  gradients, on the first half of the batch alone;
- ``unchanged``: the optimizer's step leaves every leaf as it was;
- ``altered_answers``: the forward returns every second row's logits
  rolled by one class.

These runs are not part of the benchmark's own; the limits files say which
readings each limit was set from.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from unittest import mock

from portbench import run
from portbench.reference import resnet as ref_resnet


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted underneath (None: as it is)."""
    from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda
    from petastorm_tpu_torch.models import resnet

    if fault is None:
        yield
        return
    if fault == "half_batch":
        update = train_resnet_cuda.TrainStep.update

        def half(self, x, labels):
            n = x.shape[0] // 2
            return update(self, x[:n], labels[:n])

        patch = mock.patch.object(train_resnet_cuda.TrainStep, "update", half)
    elif fault == "unchanged":
        def update(self, x, labels):
            loss = train_resnet_cuda.softmax_cross_entropy(self.model(x), labels,
                                                           self.num_classes)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            for leaf in self.leaves:  # the buffer the first step would make, no step
                self.optimizer.state[leaf]["momentum_buffer"] = leaf.grad.detach().clone()
            return loss.detach()

        patch = mock.patch.object(train_resnet_cuda.TrainStep, "update", update)
    elif fault == "altered_answers":
        forward = resnet.ResNet.forward

        def altered(self, images, train=False):
            out = forward(self, images, train)
            out[1::2] = out[1::2].roll(1, dims=1)
            return out

        patch = mock.patch.object(resnet.ResNet, "forward", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    with patch:
        yield


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", default=None,
                        choices=("half_batch", "unchanged", "altered_answers"))
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    for seed in args.seeds:
        with planted(args.fault):
            result = run.run_cell(args.workload, seed, args.seconds, False,
                                  control=None if args.fault else ref_resnet.FP8)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": result["correct"], "control_correct": result.get("control_correct"),
                "setup_s": result["metrics"]["setup_s"]["value"],
                "program": result["checks"], "control": result.get("control")}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
