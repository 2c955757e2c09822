"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload bert3.train --seed 12345 \\
        --seconds 20 --trace 0

from the root of a checkout. The cell's configuration, traffic and driver
are found by the names BENCHMARK.json gives. --trace 0 prints the cell's
end-to-end metrics; --trace 1 runs the window under torch.profiler and
prints its per-layer metrics, the device's busy and window seconds and a
breakdown. Every run checks what the timed path produced against the
plain reference under benchmark/reference and prints the numbers compared
beside their limits. Exits non-zero, with no result, without the CUDA
cards the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)


def work_dir(cell_name: str) -> str:
    """A new directory of this run's own for the data it writes, under
    TMPDIR (the system's temporary directory without it); the driver
    deletes it when the run ends."""
    import tempfile
    return tempfile.mkdtemp(prefix="fancyrec_bench_%s_" % cell_name)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, require_chip: bool = True, overrides=None, out=None,
        t_start: float = None) -> dict:
    """Run the cell; print and return its result. `overrides` updates the
    configuration and traffic (small shapes for tests on the CPU), and
    without `require_chip` the run takes the CPU where there is no card."""
    _environment()
    import harness

    t_start = T_START if t_start is None else t_start
    bench = harness.spec()
    cell = harness.Cell(bench, args.workload)
    for base, key in ((cell.config, "config"), (cell.traffic, "traffic")):
        for k, v in (overrides or {}).get(key, {}).items():
            if isinstance(v, dict) and isinstance(base.get(k), dict):
                base[k].update(v)
            else:
                base[k] = v
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips:
        device = torch.device("cuda", 0)
    elif require_chip:
        raise SystemExit("cell %s needs %d CUDA device(s); found %s"
                         % (cell.name, cell.chips,
                            torch.cuda.device_count()
                            if torch.cuda.is_available() else "none"))
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver()
    ctx = dict(cell=cell, seed=args.seed, seconds=args.seconds,
               trace=bool(args.trace), device=device, t_start=t_start,
               work=work_dir(cell.name))
    r = driver.run(ctx)
    found = harness.forbidden_modules()
    if found:
        raise SystemExit("JAX or the JAX package was loaded: %s" % found)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m).read(r["observed"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(r["e2e"][m["name"]]),
                                  "unit": units[m["name"]]}
    dev = dict(r["device"])
    if args.trace:
        window = r["observed"]["window"]
        dev["busy_s"] = window.busy_s()
        dev["window_s"] = window.seconds
    result = {"correct": bool(r["correct"]), "attempted": int(r["attempted"]),
              "failed": int(r["failed"]), "metrics": metrics, "device": dev,
              "card": r.get("card", {})}
    if args.trace:
        result["breakdown"] = r["observed"]["window"].breakdown()
    return harness.emit(result, r["checks"], out=out)


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
