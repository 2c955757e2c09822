"""The readings that a cell's limits are set from, on the chip.

    python3 benchmark/controls.py --workload bert3.train --seeds 1 2 3 \\
        --seconds 4

For each seed, one line of JSON: the numbers the cell compares, as the
program gives them (its run with a short window), and as each control
gives them: the plain reference computed one precision below the
configuration's (TF32 for float32, fp8 for bfloat16) and
the faults the cell can have, planted in the reference put in the
program's place. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

import run  # noqa: E402


def extract_controls(cell, seed, dev):
    import torch
    import generate
    import weights as bench_weights
    from reference import resnet_ref
    ext = cell.config["extractor"]
    params = bench_weights.make(bench_weights.resnet_spec(ext["blocks"]),
                                seed, dev)
    pool = generate.frame_pool(cell.traffic["pool_frames"],
                               ext["image_size"], seed, dev)
    pick = generate.rng_for(seed, 4).choice(
        len(pool), cell.traffic["check_frames"], replace=False)
    frames = pool[torch.from_numpy(pick).to(dev)]
    want, fp8 = [], []
    for i in range(0, len(pick), 8):
        want.append(resnet_ref.features(params, ext["blocks"],
                                        frames[i:i + 8]))
        fp8.append(resnet_ref.features(params, ext["blocks"],
                                       frames[i:i + 8], fp8=True))
    want, fp8 = torch.cat(want), torch.cat(fp8)

    def err(got):
        return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())

    return {"fp8": {"feature_error": err(fp8)},
            "answer_altered": {"feature_error": err(want.roll(1, 0))}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--program", type=int, default=1,
                   help="also run the program's cell on each seed")
    a = p.parse_args(argv)
    run._environment()
    import harness
    import torch
    cell = harness.Cell(harness.spec(), a.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in a.seeds:
        t0 = time.time()
        rec = {"workload": a.workload, "seed": seed}
        if cell.traffic["driver"] == "train":
            r = cell.driver().run(dict(
                cell=cell, seed=seed, seconds=a.seconds, trace=False,
                device=dev, t_start=time.time(), control=True,
                work=run.work_dir(cell.name)))
            rec["program"] = {k: v for k, (v, _) in r["checks"].items()}
            rec["controls"] = r["controls"]
        else:
            if a.program:
                r = cell.driver().run(dict(
                    cell=cell, seed=seed, seconds=a.seconds, trace=False,
                    device=dev, t_start=time.time(),
                    work=run.work_dir(cell.name)))
                rec["program"] = {k: v for k, (v, _) in r["checks"].items()}
            rec["controls"] = extract_controls(cell, seed, dev)
        rec["seconds"] = time.time() - t0
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
