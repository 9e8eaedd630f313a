"""Readings for the limits of the check of the cell on the mc estimator on
the stopping table (``simult-mc``): the program's numbers over many
seeds, and two controls' beside them, in one process (the kernels built
once).

    python3 portbench/control_mc_table.py --seconds 5
        --seeds 11 12 13 ... [--out control_simult-mc.jsonl]

For each seed: the cell's set-up and a window of ``--seconds`` as a run
makes them, then the check's numbers for the program and for two
controls put in its place, at the same proposals, seed words and
uniforms: 'tf32', the mc-table reference with its matrix products (the A
contraction and the timing convolution) in TF32, the nearest precision
below the float32 products the campaign states; 'moments_bf16', the
reference with its fine-cell moments rounded to bfloat16 before the
contraction (the cubic reconstruction cancels across the four channel
rows, so this costs several percent of the grid).  One JSON line a seed.
Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def tf32_reference(camp, observed, device):
    from portbench.reference.mc_table import Reference
    return Reference(camp, observed, device, tf32=True)


def moments_bf16_reference(camp, observed, device):
    from portbench.reference.mc_table import Reference

    class MomentsBf16(Reference):
        def fine_moments(self, e0):
            return super().fine_moments(e0).bfloat16().float()

    return MomentsBf16(camp, observed, device)


CONTROLS = {"tf32": tf32_reference, "moments_bf16": moments_bf16_reference}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="simult-mc")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness, plan as plans
    if not torch.cuda.is_available():
        print("control_mc_table: needs a CUDA card", file=sys.stderr)
        return 2
    plan = plans.resolve(args.workload, plans.benchmark(ROOT), ROOT)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run(plan, seed, args.seconds, False, t_start=t0,
                          log=lambda s: print(s, file=sys.stderr),
                          controls=CONTROLS)
        line = {"workload": plan.cell, "seed": seed,
                "program": out["numbers"],
                **{f"control_{k}": v for k, v in out["controls"].items()},
                "correct": out["correct"],
                "failed": out["failed"], "attempted": out["attempted"],
                "walker_steps_per_s": out["window"]["walker_steps_per_s"],
                "memory_peak_bytes": out["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
