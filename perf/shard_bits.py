"""Why the forward's matrix products (the A contraction, the timing
convolutions) run in products of a fixed row count: a shard's bits
against the whole batch's, with one product over all rows and with
``ops/rowwise.rowwise_matmul``, on the card.

For each way of multiplying (``one product``: ``x @ A`` over all rows, as
before the fixed-row products; ``fixed rows``: the port's), at full
width:

* the stages of the simultFit counts forward (grid, lattice draws, K2's
  histogram, spectra) for the second half of a batch evaluated alone with
  its ``walker_offset``, against those rows of the whole batch: the
  half-step (128 walkers -> 64) and the initial evaluation (256 -> 128),
  and one tempered half-update of ``-model tof`` (1000 -> 500);
* 5 PT steps of ``-model tof`` (20 x 100 walkers, 2 runs, 50k draws)
  whose log-likelihood evaluates two shards in turn (as two ranks do)
  against the unsharded ``sample_pt``, and 20 DE steps of the simultFit
  counts fit (256 walkers, 4 runs, 200k draws) the same way: positions
  and log-likelihoods bitwise or not, the largest difference.

    python perf/shard_bits.py --out chiprun_out/shard_bits.json

One JSON line on stdout.  Needs a CUDA GPU.  On the card the A
contraction's float32 product is now a kernel whose rows do not depend on
the batch (``ops/cuda_contract.py``), so the two ways differ there in the
timing convolutions alone.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mcmctoffitting_tpu_torch import sampler  # noqa: E402
from mcmctoffitting_tpu_torch.cli import shifting_gaussian  # noqa: E402
from mcmctoffitting_tpu_torch.models import simult  # noqa: E402
from mcmctoffitting_tpu_torch.ops import e0grid, timing  # noqa: E402
from mcmctoffitting_tpu_torch.utils import data_io  # noqa: E402

FIXED_ROWS = e0grid.rowwise_matmul


def stages(fwd, params, scales, offset):
    gen = torch.Generator().manual_seed(5)
    grids, means = fwd.grid_and_mean(params, gen, walker_offset=offset)
    base, draws = fwd.lattice(grids, means)
    hist = fwd.tof_histogram(base.contiguous(), draws)
    return {"grid": grids, "draws": draws, "hist": hist,
            "spectra": fwd.shape_spectra(hist, scales)}


def shard_stages_equal(problem, thetas):
    """The second half of ``thetas`` alone against the whole batch."""
    params, scales, _ = problem.split_theta(thetas)
    m = thetas.shape[0] // 2
    whole = stages(problem.forward, params, scales, 0)
    part = stages(problem.forward, params[m:], scales[m:], m)
    return {k: bool(torch.equal(whole[k][m:], part[k])) for k in whole}


def two_shards(logp, **kw):
    """A log-prob that evaluates two halves in turn from one generator
    state, as two ranks do (``parallel/mesh.py``, contract A)."""
    def f(thetas, gen):
        state, m = gen.get_state(), thetas.shape[0] // 2
        out = []
        for r in range(2):
            gen.set_state(state)
            out.append(logp(thetas[r * m:(r + 1) * m], gen,
                            walker_offset=r * m, **kw))
        return torch.cat(out)
    return f


def two_shards_pt(loglike, n_temps):
    def f(thetas, gen):
        n = thetas.shape[0] // n_temps
        m, state, out = n // 2, gen.get_state(), []
        for r in range(2):
            gen.set_state(state)
            rows = thetas.reshape(n_temps, n, -1)[:, r * m:(r + 1) * m]
            out.append(loglike(rows.reshape(n_temps * m, -1), gen,
                               walker_offset=r * m,
                               walker_blocks=(m, n)).reshape(n_temps, m))
        return torch.cat(out, 1).reshape(-1)
    return f


def compare(a, b):
    """Bitwise or not; the largest difference where both are finite."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return {"bitwise": bool(torch.equal(a, b)),
            "max_abs_diff": float((a[fin] - b[fin]).abs().max())}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="")
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    spec = simult.default_spec(n_samples=200_000, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=4, likelihood="poisson",
                                      device=dev)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    observed = data_io.synthesize_observed(9, problem, truth)
    logp = problem.make_log_prob_fn(observed)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), 256, observed)
    pt_problem, _, loglike, logprior, p_pt = shifting_gaussian.tof_pt_setup(
        0, 20, 100, dev)
    out = {"card": smi}
    for mode, matmul in (("one product", lambda x, a: x @ a),
                         ("fixed rows", FIXED_ROWS)):
        e0grid.rowwise_matmul = timing.rowwise_matmul = matmul
        row = {"stages_half_step": shard_stages_equal(
                   problem, p0[::2].contiguous()),
               "stages_initial": shard_stages_equal(problem, p0),
               "stages_pt_half_update": shard_stages_equal(
                   pt_problem, p_pt.reshape(-1, pt_problem.n_dim)[:1000])}
        chains = []
        for batch in (None, two_shards_pt(loglike, 20)):
            c = sampler.sample_pt(
                p_pt, 5, loglike, logprior, stochastic=True,
                generator=torch.Generator(dev).manual_seed(4),
                eval_generator=torch.Generator().manual_seed(5),
                loglike_batch=batch)
            chains.append((c.positions, c.log_like))
        row["pt_positions"] = compare(*(c[0] for c in chains))
        row["pt_log_like"] = compare(*(c[1] for c in chains))
        chains = []
        for batch in (logp, two_shards(logp)):
            state = sampler.init_state(
                p0, batch, generator=torch.Generator(dev).manual_seed(2),
                eval_generator=torch.Generator().manual_seed(3))
            c = sampler.run_mcmc(state, 20, batch, move="de")
            chains.append((c.positions, c.log_probs))
        row["de_positions"] = compare(*(c[0] for c in chains))
        row["de_log_probs"] = compare(*(c[1] for c in chains))
        out[mode] = row
        print(f"{mode} ({smi}): {row}", file=sys.stderr, flush=True)
    e0grid.rowwise_matmul = timing.rowwise_matmul = FIXED_ROWS
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
