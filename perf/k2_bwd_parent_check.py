"""K2's backward at its three shapes, a checkout's kernel against another's.

Runs ``ops/cuda_tof.tof_hist_segments_backward`` (kernel ``tof_hist_bwd``)
of the port in the checkout ``--root`` at three shapes, with inputs made
from numpy seed 13 (base times uniform over the runs' windows and 10 ns
beyond, zt uniform in [-6, 6) ns, zw uniform in [0, 1), the cotangent
standard normal):

* ``simult``: (256, 4, 10, 50), K = 10, simultFit's windows (70 bins):
  a gradient evaluation of simultFit 'expected';
* ``onebd``: (256, 3, 20, 400), K = 1, oneBD's windows (25 bins): a
  gradient evaluation of oneBD;
* ``templates``: (32, 4, 100, 150), K = 1, simultFit's windows: the
  templates' lattice.

The first run with ``--save`` stores the outputs; every later run reports,
per shape, whether its output equals the stored one bit for bit and the
largest difference.  Each run also calls the kernel a second time and
reports whether the two calls gave the same bits.  Times are device times
(``utils/devtime.graphs_in_turns``: 100 launches in a replayed CUDA graph,
three measurements of six rounds each), beside the launch floor, the
bytes bound (base and the cotangent read once, the gradient written once,
at 3.35 TB/s) and, in turns with the kernel, a device copy of base into a
tensor of its shape (``copy_``: the same bytes but the cotangent's, a
yardstick of the memory rate a kernel reaches at this size; the replays
read the same inputs again, so they may sit in the 50 MB L2).  Run the
checkouts in turns on one card, e.g. parent, change, change, parent:

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python perf/k2_bwd_parent_check.py --root build/parent --label parent --save
    python perf/k2_bwd_parent_check.py --root . --label change

One JSON line per run on stdout; the stored outputs go to ``--out``.
Needs a CUDA GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True,
                   help="checkout whose mcmctoffitting_tpu_torch to run")
    p.add_argument("--label", required=True)
    p.add_argument("--save", action="store_true",
                   help="store this run's outputs as the ones to compare")
    p.add_argument("--out", default="build/k2_bwd_parent_check")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from mcmctoffitting_tpu_torch.constants import (tof_windows,
                                                    tof_windows_onebd)
    from mcmctoffitting_tpu_torch.ops import cuda_tof
    from mcmctoffitting_tpu_torch.ops.histogram import window_constants
    from mcmctoffitting_tpu_torch.utils import devtime

    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_parent_check: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    simult = tuple(tof_windows[n] for n in ("mid", "close", "close", "far"))
    onebd = tuple(tof_windows_onebd[n] for n in ("close", "mid", "far"))
    shapes = {"simult": ((256, 4, 10, 50), 10, simult),
              "onebd": ((256, 3, 20, 400), 1, onebd),
              "templates": ((32, 4, 100, 150), 1, simult)}
    rng = np.random.default_rng(13)
    where = Path(args.out)
    where.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"label": args.label, "root": args.root,
              "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi.strip().splitlines()[0] if smi else None,
              "launch_floor_ms": devtime.launch_floor_ms(dev)}
    variant = getattr(cuda_tof, "tof_hist_backward_variant", None)
    for name, (shape, k, windows) in shapes.items():
        def f32(a):
            return torch.as_tensor(a.astype(np.float32), device=dev)

        lo = min(w.lo for w in windows) - 10.0
        hi = max(w.hi for w in windows) + 10.0
        base = f32(rng.uniform(lo, hi, shape))
        zt = f32(rng.uniform(-6.0, 6.0, (shape[-1], k)))
        zw = f32(rng.uniform(0.0, 1.0, (shape[-1], k)))
        win = window_constants(windows, device=dev)
        gbar = f32(rng.standard_normal(shape[:-2] + (win.n_pad,)))

        def call():
            return cuda_tof.tof_hist_segments_backward(gbar, base, zt, zw,
                                                       win)

        copy_to = torch.empty_like(base)

        def copy():
            return copy_to.copy_(base)

        out = call()
        second = torch.equal(call(), out)
        out = out.cpu()
        turns = [devtime.graphs_in_turns({"bwd": call, "copy": copy})
                 for _ in range(3)]
        n_rows = base.numel() // (shape[-2] * shape[-1])
        n_bytes = 4 * (2 * base.numel() + n_rows * win.n_pad
                       + 2 * zt.numel())
        entry = {"ms": [t["bwd"] for t in turns],
                 "copy_ms": [t["copy"] for t in turns],
                 "shape": list(shape), "k": k,
                 "n_pad": win.n_pad,
                 "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                 "variant": variant(k) if variant else None,
                 "same_bits_on_second_call": second}
        ref = where / f"output_{name}.pt"
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
