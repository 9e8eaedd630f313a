"""K4 at its two largest shapes, a checkout's kernel against another's.

Runs kernel K4 (``ops/cuda_transport.transport_moments``) of the port in
the checkout ``--root`` at two shapes:

* ``simult``: (512, 200k) initial energies (numpy seed 0, normal(1700 keV,
  60 keV)), M = 10 depths, Be = 50 bins, one RK4 substep: the simultFit
  mc/ODE half-step;
* ``templates``: the templates' (128, 200k) energies
  (``models/templates.draw_template_energies``, host seed 20), M = 100,
  Be = 150, 4 substeps, in depth tiles.

The first run with ``--save`` stores the outputs; every later run reports,
per shape, whether its output equals the stored one bit for bit and the
largest difference.  Each run also calls K4 a second time and reports
whether the two calls gave the same bits.  Times are device times
(``utils/devtime.queued_ms``, 10 launches behind one of their own at the
first shape, 3 at the second, three rounds).  Run the checkouts in turns
on one card, e.g. parent, change, change, parent:

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python perf/k4_parent_check.py --root build/parent --label parent --save
    python perf/k4_parent_check.py --root . --label change

One JSON line per run on stdout; the stored outputs go to ``--out``.
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
                   help="store this run's outputs as the ones to compare")
    p.add_argument("--out", default="build/k4_parent_check")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from mcmctoffitting_tpu_torch.config import (SIMULTFIT_ED_BINNING,
                                                 SIMULTFIT_X_BINNING)
    from mcmctoffitting_tpu_torch.models import templates
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
    spec = templates.default_spec(200_000)
    fwd = templates.template_forward(spec, device=dev)
    e0_t, _ = templates.draw_template_energies(
        spec, torch.Generator().manual_seed(20), 4, dev)
    shapes = {
        "simult": (e0, rk4, cuda_transport.MomentBins(eb.lo, eb.hi, eb.n),
                   10),
        "templates": (e0_t.reshape(-1, 200_000).contiguous(), fwd.rk4,
                      fwd.moment_bins, 3),
    }
    where = Path(args.out)
    where.mkdir(parents=True, exist_ok=True)
    result = {"label": args.label, "root": args.root,
              "device": torch.cuda.get_device_name(0)}
    for name, (rows, c, bins, launches) in shapes.items():
        def call():
            return cuda_transport.transport_moments(rows, c, bins)

        out = call()
        second = torch.equal(call(), out)
        out = out.cpu()
        ms = [devtime.queued_ms(call, launches=launches) for _ in range(3)]
        ref = where / f"output_{name}.pt"
        entry = {"ms": ms, "shape": list(rows.shape), "n_x": len(c.h),
                 "n_bins": bins.n_bins, "same_bits_on_second_call": second}
        if args.save:
            torch.save(out, ref)
        else:
            saved = torch.load(ref)
            entry["bitwise_equal_to_saved"] = bool(torch.equal(saved, out))
            entry["max_abs_diff_to_saved"] = float(
                (saved - out).abs().max())
        result[name] = entry
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
