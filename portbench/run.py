"""The benchmark of the PyTorch and CUDA port, one cell per run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the root of the checkout, sets
it up (kernels, problem, data and walkers from the seed, a warm-up
segment), measures it for ``--seconds`` (``--trace 0``: the end-to-end
metrics; ``--trace 1``: spans and a profiled sub-window, the per-layer
metrics), checks what the timed path computed against the plain
reference, and prints one JSON object as the last line of its standard
output.  Without a CUDA card, or with fewer cards than the cell asks for,
it exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, plan as plans
    plan = plans.resolve(args.workload, plans.benchmark(ROOT), ROOT)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "False); nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < plan.chips:
        print(f"portbench: {plan.cell} needs {plan.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    def log(text):
        print(f"portbench: {text}", file=sys.stderr, flush=True)

    out = harness.run(plan, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    result = harness.result_line(plan, out, harness.card(),
                                 bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
