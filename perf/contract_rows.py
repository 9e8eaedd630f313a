"""The forward's matrix products (the A contraction, the timing
convolution) as one product against products of a fixed row count
(``ops/rowwise.rowwise_matmul``), at the row counts each path gives them,
on the card.

For every shape: the device ms of ``x @ A`` (one product over all rows)
and of ``rowwise_matmul(x, A)``, timed in turns (``utils/devtime``: 100
calls in a replayed CUDA graph each), the host's enqueue microseconds of
each, and whether the rows of the first half of the batch, computed
alone, equal the whole batch's rows bit for bit under each (what a shard
of the walkers sees).  The matrices are the forwards' own; x is uniform
random (numpy seed 0).  Shapes (rows = walkers x runs):

* simult counts half-step, 128 x 4 = 512 rows, F = 512 (K = 2048);
* its shard on two ranks, 256 rows, and the initial evaluation, 1024;
* simult 'expected', one grid per walker: 128 rows, F = 256;
* oneBD hardcore counts, 128 x 3 = 384 rows, F = 1024, M x Be = 8000;
* PT -model tof half-update, 1000 x 2 = 2000 rows, F = 1024 at 50k draws;
* the timing convolution (n_pad x n_pad) of the simultFit half-step (512
  rows) and of the PT half-update (2000 rows).

    python perf/contract_rows.py --out chiprun_out/contract_rows.json

One JSON line on stdout.  Needs a CUDA GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mcmctoffitting_tpu_torch.models import onebd, simult  # noqa: E402
from mcmctoffitting_tpu_torch.ops.rowwise import rowwise_matmul  # noqa: E402
from mcmctoffitting_tpu_torch.utils import devtime  # noqa: E402


def forward(model, dev, **spec_args):
    if model == "simult":
        spec = simult.default_spec(**spec_args)
        return simult.SimultFitProblem(spec, n_runs=4, device=dev).forward
    spec = onebd.default_spec(**spec_args)
    return onebd.OneBDProblem(spec, n_runs=3, device=dev).forward


def operator(model, dev, **spec_args):
    return forward(model, dev, **spec_args).e0grid.a_matrix


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="")
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    counts = operator("simult", dev, n_samples=200_000, sampling="counts")
    cases = {
        "simult_counts_half_step": (counts, 512),
        "simult_counts_shard_of_2": (counts, 256),
        "simult_counts_initial": (counts, 1024),
        "simult_expected_half_step": (operator(
            "simult", dev, n_samples=200_000, sampling="expected"), 128),
        "onebd_hardcore_counts_half_step": (operator(
            "onebd", dev, n_samples=200_000, hardcore=True,
            sampling="counts"), 384),
        "pt_tof_half_update": (operator(
            "simult", dev, n_samples=50_000, sampling="counts"), 2000),
    }
    timing = forward("simult", dev, n_samples=200_000,
                     sampling="counts").timing
    cases.update(timing_simult_half_step=(timing, 512),
                 timing_pt_half_update=(timing, 2000))
    rng = np.random.default_rng(0)
    rows = {}
    for name, (a, n) in cases.items():
        x = torch.as_tensor(rng.uniform(0.0, 1.0, (n, a.shape[0])).astype(
            np.float32), device=dev)
        half = x[: n // 2].contiguous()
        one = {"one product": lambda: x @ a,
               "fixed rows": lambda: rowwise_matmul(x, a)}
        ms = devtime.graphs_in_turns(one)
        rows[name] = {
            "rows": n, "k": a.shape[0], "n": a.shape[1],
            "one_product_ms": ms["one product"],
            "fixed_rows_ms": ms["fixed rows"],
            "one_product_enqueue_us": devtime.enqueue_us(one["one product"]),
            "fixed_rows_enqueue_us": devtime.enqueue_us(one["fixed rows"]),
            "half_rows_equal_one_product": bool(torch.equal(
                half @ a, (x @ a)[: n // 2])),
            "half_rows_equal_fixed_rows": bool(torch.equal(
                rowwise_matmul(half, a), rowwise_matmul(x, a)[: n // 2])),
        }
        print(f"{name} ({smi}): {rows[name]}", file=sys.stderr, flush=True)
    out = {"card": smi, "torch": torch.__version__, "shapes": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
