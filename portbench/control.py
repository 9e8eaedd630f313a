"""Readings for the limits of a cell's check: the program's numbers over
many seeds, and the control's beside them, in one process (the kernels
built once).

    python3 portbench/control.py --workload <cell> --seconds 5
        --seeds 11 12 13 ... [--fault <name>] [--out control_<cell>.jsonl]

For each seed: the cell's set-up and a window of ``--seconds`` as a run
makes them, then the check's numbers for the program, and for the
control: the reference itself with its matrix products in TF32 (the
nearest precision below the float32, TF32-off products the campaign
states) put in the program's place, at the same proposals, seed words
and uniforms.  With ``--fault`` the program runs with one of
``faults.py``'s faults planted.  One JSON line a seed.  Needs a CUDA
card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def tf32_reference(camp, observed, device):
    from portbench.reference.forward import Reference
    return Reference(camp, observed, device, tf32=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import faults, harness, plan as plans
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        faults.plant(args.fault)
    plan = plans.resolve(args.workload, plans.benchmark(ROOT), ROOT)
    lines = []
    for seed in args.seeds:
        out = harness.run(plan, seed, args.seconds, False,
                          t_start=time.perf_counter(),
                          log=lambda s: print(s, file=sys.stderr),
                          controls={"tf32": tf32_reference})
        line = {"workload": plan.cell, "seed": seed, "fault": args.fault,
                "program": out["numbers"],
                "control_tf32": out["controls"]["tf32"],
                "failed": out["failed"], "attempted": out["attempted"],
                "walker_steps_per_s":
                out["window"]["walker_steps_per_s"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
