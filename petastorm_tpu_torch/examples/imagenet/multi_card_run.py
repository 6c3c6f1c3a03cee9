"""The data-parallel trainer and the selfcheck on several cards, one rank a card.

Run from the root of a checkout on a machine with four cards::

    python3 -m petastorm_tpu_torch.examples.imagenet.multi_card_run [OUT_DIR]

It writes ``chip_smoke.py``'s phase-4 dataset (4096 JPEG rows of 224 x 224,
16 rowgroups of 256, labels in [0, 1000)), then runs
``train_resnet_cuda`` under ``torch.distributed.run --standalone``: one card
at a batch of 256, four cards at a global batch of 1024 over NCCL (256 a
card), the same with ``--scan-steps 4`` (the all-reduce captured in the
CUDA graph), and one card again, 2 warm-up units and 12 timed steps each,
in this order in one call, so the four-card samples/s/GPU reads against one
card's on the same machine.  Then the six selfcheck checks with one rank a
card (NCCL by default): pipeline, write, cp, shuffled and mixed on 4 ranks,
mesh2d on 2 x 2.  Each run prints one JSON line; the ranks' reports go to
``OUT_DIR`` (default ``multi_card`` under the temporary directory).
"""

import json
import os
import subprocess
import sys
import tempfile
import time


def main(out: str) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np

    import chip_smoke as cs

    os.makedirs(out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t00 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="multi_card_") as tmp:
        path = os.path.join(tmp, "imagenet")
        t0 = time.perf_counter()
        cs.write_labelled_jpegs(path, np.random.default_rng(0).permutation(cs.N_ROWS) % 1000, 0)
        print("write_s", time.perf_counter() - t0, flush=True)
        base = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
        train = ["-m", "petastorm_tpu_torch.examples.imagenet.train_resnet_cuda", "--dataset-url",
                 path, "--skip-generate", "--decode", "device", "--workers", "7"]
        runs = [("one_card", 1, ["--global-batch", "256", "--steps", "12", "--warmup", "2"]),
                ("four_cards", 4, ["--global-batch", "1024", "--steps", "12", "--warmup", "2"]),
                ("four_cards_scan4", 4, ["--global-batch", "1024", "--steps", "12", "--warmup",
                                         "1", "--scan-steps", "4"]),
                ("one_card_again", 1, ["--global-batch", "256", "--steps", "12", "--warmup", "2"])]
        for name, n, extra in runs:
            prefix = os.path.join(out, name)
            t0 = time.perf_counter()
            r = subprocess.run(base + ["--nproc-per-node", str(n)] + train + extra
                               + ["--report", prefix], capture_output=True, text=True,
                               timeout=600)
            wall = time.perf_counter() - t0
            print(f"== {name} rc={r.returncode} wall={wall:.1f}s", flush=True)
            if r.returncode:
                print(r.stdout[-3000:], r.stderr[-6000:], flush=True)
                continue
            reports = [json.load(open(f"{prefix}.{k}.json")) for k in range(n)]
            keep = ("world_size", "transport", "samples_per_sec", "samples_per_sec_per_gpu",
                    "allreduce_ms", "device_idle_pct", "input_stall_pct", "wall_s", "steps",
                    "scan_steps", "final_loss", "params_digest", "launches", "device_kind")
            print(json.dumps({name: [{k: rep.get(k) for k in keep} for rep in reports]}),
                  flush=True)
    for phase, n, extra in (("pipeline", 4, []), ("write", 4, []), ("cp", 4, []),
                            ("shuffled", 4, []), ("mixed", 4, []),
                            ("mesh2d", 2, ["--devices-per-process", "2"])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.parallel.selfcheck",
                            "--phase", phase, "--num-processes", str(n), "--timeout", "300"]
                           + extra, capture_output=True, text=True, timeout=700)
        wall = time.perf_counter() - t0
        try:
            rep = json.loads(r.stdout[r.stdout.index("{"):])
            rep.pop("logs", None)
            if rep.get("ok"):
                rep.pop("failures", None)
            else:
                rep["failures"] = [f[-3000:] for f in rep["failures"]]
        except ValueError:
            rep = {"stdout": r.stdout[-2000:], "stderr": r.stderr[-3000:]}
        print(json.dumps({"selfcheck": phase, "rc": r.returncode, "wall_s": wall, **rep}),
              flush=True)
    print("total_s", time.perf_counter() - t00)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "multi_card"))
