"""K4 at the simultFit half-step, a checkout's kernel against another's.

Runs kernel K4 (``ops/cuda_transport.transport_moments``) of the port in
the checkout ``--root`` at (512, 200k) initial energies (numpy seed 0,
normal(1700 keV, 60 keV)), M = 10 depths, Be = 50 bins, one RK4 substep:
the simultFit mc/ODE half-step's shape.  The first run with ``--save``
stores the output; every later run compares its output with it bit for
bit.  Times are device times (``utils/devtime.queued_ms``, 10 launches
behind one of their own, three rounds).  Run the checkouts in turns on
one card, e.g. parent, change, change, parent:

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python perf/k4_parent_check.py --root build/parent --label parent --save
    python perf/k4_parent_check.py --root . --label change

One JSON line per run on stdout; the stored output goes to ``--out``.
Needs a CUDA GPU.
"""
import argparse
import json
import sys
from pathlib import Path


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True,
                   help="checkout whose mcmctoffitting_tpu_torch to run")
    p.add_argument("--label", required=True)
    p.add_argument("--save", action="store_true",
                   help="store this run's output as the one to compare")
    p.add_argument("--out", default="build/k4_parent_check")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from mcmctoffitting_tpu_torch.config import (SIMULTFIT_ED_BINNING,
                                                 SIMULTFIT_X_BINNING)
    from mcmctoffitting_tpu_torch.ops import cuda_transport, stopping
    from mcmctoffitting_tpu_torch.utils import devtime

    if not torch.cuda.is_available():
        raise SystemExit("k4_parent_check: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    e0 = torch.as_tensor(rng.normal(1700.0, 60.0, (512, 200_000)).astype(
        np.float32), device=dev)
    rk4 = stopping.rk4_constants(stopping.d2_gas_stopping(8.565e-5),
                                 SIMULTFIT_X_BINNING.centers, 1)
    eb = SIMULTFIT_ED_BINNING
    bins = cuda_transport.MomentBins(eb.lo, eb.hi, eb.n)
    out = cuda_transport.transport_moments(e0, rk4, bins).cpu()
    ms = [devtime.queued_ms(
        lambda: cuda_transport.transport_moments(e0, rk4, bins),
        launches=10) for _ in range(3)]
    where = Path(args.out)
    where.mkdir(parents=True, exist_ok=True)
    ref = where / "output.pt"
    result = {"label": args.label, "root": args.root,
              "device": torch.cuda.get_device_name(0), "ms": ms}
    if args.save:
        torch.save(out, ref)
    else:
        result["bitwise_equal_to_saved"] = bool(torch.equal(
            torch.load(ref), out))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
