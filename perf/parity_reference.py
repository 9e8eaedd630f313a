"""The JAX package's side of the port's posterior parity, on the CPU.

For each case of ``mcmctoffitting_tpu_torch.utils.parity.CASES`` this
writes ``perf/parity/<case>.npz`` and a readable ``<case>.json``:

* the observed runs, made by the JAX package's
  ``utils/data_io.py::synthesize_observed`` from the key that ``bench.py``
  uses (``fold_in(threefry key 0, 9)``); simultFit at bench's truth, from
  the counts problem, the same arrays for every simultFit case; oneBD at
  its CLI's synthetic truth;
* the spec fields that define the case and the git commit;
* for a case with a chain: the JAX DE chain (the package's ``init_state``
  / ``run_mcmc(..., move='de')`` from its ``initial_walkers_from_observed``):
  a burn-in of at least 300 steps that goes on while the ensemble's median
  log-prob still rises by more than 1 nat a block of 100, then main
  blocks until every parameter has ESS >= ``min_ess`` (or the cap),
  and kept as its summary only: per parameter the 16/50/84 percentiles,
  the median's standard error, tau and ESS, with acceptance, steps and
  walkers;
* 48 thetas drawn from the chain's retained samples (rng seed 11, as in
  ``tools/parity_density_check.py``); the mc cases take the thetas of
  ``simult_counts`` (the same posterior);
* the JAX log-prob at each theta: mean and standard deviation over 16
  keys, or for 'expected' its value and ``jax.grad``.

Usage (full width: 200k draws, the presets' F, 256 walkers):

    JAX_PLATFORMS=cpu PYTHONPATH=. python perf/parity_reference.py <case> [...]

``simult_counts`` must exist before the mc cases.  On an 8-core host
the simultFit chains take 10-16 min, oneBD's 1.8 h (its ensemble accepts
~0.1% of its moves), the mc density tables 3 and 9 min.  ``--replicate
--seed N`` runs a case's chain alone and writes its summary as
``<case>_seed<N>.json`` at the reference chain's length: the JAX
package's own chain-to-chain spread.
The card's side is ``perf/posterior_parity.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mcmctoffitting_tpu.models import onebd, simult  # noqa: E402
from mcmctoffitting_tpu.sampler.stretch import (init_state,  # noqa: E402
                                                make_logp_batch, run_mcmc)
from mcmctoffitting_tpu.utils import data_io  # noqa: E402
from mcmctoffitting_tpu_torch.utils.parity import (CASES,  # noqa: E402
                                                   chain_summary,
                                                   param_names)

OUT = REPO / "perf" / "parity"
SPEC_FIELDS = ("transport", "rk4_substeps", "zero_degree", "cell_attenuation",
               "add_half_zero_deg", "beam_source", "bg_mode", "n_samples",
               "rint_draws", "n_redraw_rounds", "xs_mode", "e0_grid_fine",
               "sampling", "e0_mean_mode", "moment_closure", "a_dtype")
ONEBD_TRUTH = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4, 20.0, 20.0, 20.0])
THETA_SEED = 11
BURN_RISE = 1.0


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A case's sizes; the defaults are full width."""

    n_runs: int | None = None      # simultFit 4, oneBD 3
    n_draws: int = 200_000
    fine_grid: int | None = None   # the preset's F
    walkers: int = 256
    burnin: int = 300              # at least; see run_chain
    max_burnin: int = 3000
    main: int = 700
    block: int = 100               # steps per compiled chain segment
    min_ess: float = 2000.0
    max_main: int = 10000
    n_thetas: int = 48
    repeats: int = 16
    chunk: int | None = None       # walkers per vmapped chunk (mc)


def _spec(case: dict, sizes: Sizes, sampling=None):
    sampling = sampling or case["sampling"]
    if case["model"] == "simult":
        spec = simult.default_spec(sizes.n_draws, fine_grid=sizes.fine_grid,
                                   transport=case.get("transport", "table"),
                                   xs_mode=case.get("xs_mode", "e0grid"),
                                   sampling=sampling)
    else:
        spec = onebd.default_spec(sizes.n_draws, fine_grid=sizes.fine_grid,
                                  hardcore=case.get("hardcore", False),
                                  sampling=sampling)
    return dataclasses.replace(spec,
                               rint_draws=case.get("rint_draws", True))


def _problem(case: dict, sizes: Sizes, spec):
    if case["model"] == "simult":
        return simult.SimultFitProblem(spec, n_runs=sizes.n_runs or 4,
                                       likelihood="poisson")
    return onebd.OneBDProblem(spec, n_runs=sizes.n_runs or 3,
                              likelihood="poisson")


def observed_for(case: dict, sizes: Sizes):
    """bench.py's synthetic data: simultFit from its counts problem at
    bench's truth, oneBD at its CLI's truth (made once per process)."""
    return _synthesize(case["model"], case.get("hardcore", False), sizes)


@functools.lru_cache(maxsize=None)
def _synthesize(model: str, hardcore: bool, sizes: Sizes):
    key = jax.random.fold_in(jax.random.key(0, impl="threefry2x32"), 9)
    counts = {"model": model, "hardcore": hardcore, "sampling": "counts"}
    problem = _problem(counts, sizes, _spec(counts, sizes))
    if model == "simult":
        truth = np.concatenate([simult.GUESS_SHARED,
                                np.full(problem.n_runs, 5.0e4)])
    else:
        r = problem.n_runs
        truth = np.concatenate([ONEBD_TRUTH[:3 + r], ONEBD_TRUTH[6:6 + r]])
    return data_io.synthesize_observed(key, _Jitted(problem), truth)


class _Jitted:
    """The problem with its ``run_spectrum`` jitted (op-by-op dispatch
    of the eager forward costs ~8 s a run on the CPU)."""

    def __init__(self, problem):
        self.windows = problem.windows
        self.run_spectrum = jax.jit(problem.run_spectrum,
                                    static_argnums=(2,),
                                    static_argnames=("get_pdf",))


def run_chain(problem, observed, sizes: Sizes, seed: int, log=print):
    """The JAX DE chain: burn-in, then main blocks until every parameter's
    ESS >= ``sizes.min_ess`` (or ``sizes.max_main`` steps)."""
    names = param_names("simult" if isinstance(problem, simult.
                                               SimultFitProblem)
                        else "onebd", problem.n_runs)
    lb = make_logp_batch(problem.make_log_prob_fn(observed),
                         chunk=sizes.chunk)
    key = jax.random.PRNGKey(seed)
    p0 = problem.initial_walkers_from_observed(jax.random.fold_in(key, 1),
                                               sizes.walkers, observed)
    state = jax.jit(lambda k, p: init_state(k, p, lb))(
        jax.random.fold_in(key, 2), p0)
    seg = jax.jit(lambda st: run_mcmc(st, sizes.block, lb, move="de"))
    t0 = time.time()
    # burn-in: at least sizes.burnin steps, then on while the ensemble's
    # median log-prob still rises by more than BURN_RISE nats a block
    n_burn, medians = 0, [float(np.median(np.asarray(state.log_probs)))]
    while n_burn < sizes.max_burnin:
        out = seg(state)
        state = out.state
        n_burn += sizes.block
        medians.append(float(np.median(np.asarray(out.log_probs[-1]))))
        if (n_burn >= sizes.burnin
                and medians[-1] - medians[-2] <= BURN_RISE):
            break
    log(f"  burn-in {n_burn} steps: {time.time() - t0:.0f} s, median "
        f"log-prob by block {[round(m, 1) for m in medians]}")
    blocks, accepted = [], 0
    while True:
        out = seg(state)
        state = out.state
        blocks.append(np.asarray(out.positions))
        accepted += np.asarray(out.n_accepted)
        n_main = len(blocks) * sizes.block
        if n_main < sizes.main:
            continue
        chain = np.concatenate(blocks)
        summ = chain_summary(chain, names)
        ess = min(v["ess"] for v in summ.values())
        log(f"  main {n_main} steps: min ESS {ess:.0f} "
            f"({time.time() - t0:.0f} s)")
        if ess >= sizes.min_ess or n_main >= sizes.max_main:
            break
    info = {"walkers": sizes.walkers, "burnin": n_burn, "main": n_main,
            "burnin_median_log_prob": medians,
            "acceptance": float(np.mean(accepted) / n_main),
            "seconds": time.time() - t0, "seed": seed,
            "summary": summ}
    return chain, info


def draw_thetas(chain, n_thetas: int) -> np.ndarray:
    pool = chain.reshape(-1, chain.shape[-1])
    rng = np.random.default_rng(THETA_SEED)
    return pool[rng.choice(len(pool), n_thetas, replace=False)].astype(
        np.float32)


def density_table(problem, observed, thetas, sizes: Sizes, seed: int):
    """Mean and standard deviation of the log-prob over ``repeats`` keys
    at each theta (one jitted batched call)."""
    n, r = thetas.shape[0], sizes.repeats
    rows = jnp.asarray(np.tile(thetas, (r, 1)))
    keys = jax.random.split(jax.random.PRNGKey(seed), n * r)
    lb = jax.jit(make_logp_batch(problem.make_log_prob_fn(observed),
                                 chunk=sizes.chunk))
    lp = np.asarray(lb(rows, keys), np.float64).reshape(r, n).T
    return lp.mean(1), lp.std(1, ddof=1)


def value_and_grad(problem, observed, thetas):
    logp = problem.make_log_prob_fn(observed)
    f = jax.jit(jax.vmap(jax.value_and_grad(
        lambda t: logp(t, jax.random.PRNGKey(0)))))
    lp, grad = f(jnp.asarray(thetas))
    return np.asarray(lp, np.float64), np.asarray(grad, np.float64)


def git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def reference_case(name: str, sizes: Sizes = Sizes(), *, thetas=None,
                   seed: int = 0, log=print):
    """One case's reference: (meta dict, arrays dict).  The JAX chain runs
    when the case has one and no ``thetas`` are given; a case without a
    chain of its own needs ``thetas``."""
    case = CASES[name]
    t0 = time.time()
    spec = _spec(case, sizes)
    problem = _problem(case, sizes, spec)
    observed = observed_for(case, sizes)
    meta = {"case": name, "model": case["model"],
            "n_runs": problem.n_runs, "n_draws": sizes.n_draws,
            "fine_grid": sizes.fine_grid, "sampling": case["sampling"],
            "transport": spec.transport, "xs_mode": spec.xs_mode,
            "hardcore": case.get("hardcore", False),
            "rint_draws": spec.rint_draws, "likelihood": "poisson",
            "spec_fields": {f: getattr(spec, f) for f in SPEC_FIELDS},
            "jax_version": jax.__version__, "commit": git_commit(),
            "platform": jax.devices()[0].platform,
            "theta_seed": THETA_SEED, "thetas_from": case["thetas_from"]}
    chain = None
    if case["chain"] and thetas is None:
        log(f"{name}: JAX DE chain, {sizes.walkers} walkers")
        chain, meta["chain"] = run_chain(problem, observed, sizes, seed, log)
    if thetas is None:
        if chain is None:
            raise ValueError(f"{name} has no chain: pass the thetas of "
                             f"{case['thetas_from']}")
        thetas = draw_thetas(chain, sizes.n_thetas)
    thetas = np.asarray(thetas, np.float32)
    arrays = {f"observed_{r}": np.asarray(o, np.float64)
              for r, o in enumerate(observed)}
    arrays["thetas"] = thetas
    t1 = time.time()
    if case["sampling"] == "expected":
        arrays["lp"], arrays["grad"] = value_and_grad(problem, observed,
                                                      thetas)
    else:
        meta["repeats"] = sizes.repeats
        arrays["lp_mean"], arrays["lp_sd"] = density_table(
            problem, observed, thetas, sizes, seed + 7)
    meta["density_seconds"] = time.time() - t1
    meta["seconds"] = time.time() - t0
    log(f"{name}: density at {len(thetas)} thetas in "
        f"{meta['density_seconds']:.0f} s; total {meta['seconds']:.0f} s")
    return meta, arrays


def write_case(meta, arrays, out_dir=OUT):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_dir / f"{meta['case']}.npz", **arrays)
    (out_dir / f"{meta['case']}.json").write_text(
        json.dumps(meta, indent=1) + "\n")


def thetas_of(name: str, out_dir=OUT):
    with np.load(Path(out_dir) / f"{name}.npz") as z:
        return z["thetas"]


def replicate(name: str, seed: int, out_dir=OUT):
    """A second JAX chain of a case (another seed) at the reference
    chain's burn-in and main steps (``<case>.json`` in ``out_dir``), kept
    as its summary: ``perf/posterior_parity.py`` sets its dz table against
    the reference chain beside the port's.  Its length is fixed, not
    stopped by the reference's ESS rule: on a chain whose tau is long
    against its length the ESS estimate reaches the target early, and
    the two chains would not compare at the same length."""
    case = CASES[name]
    ref = json.loads((Path(out_dir) / f"{name}.json").read_text())["chain"]
    burn, main = ref["burnin"], ref["main"]
    sizes = Sizes(burnin=burn, max_burnin=burn, main=main, max_main=main,
                  min_ess=np.inf)
    problem = _problem(case, sizes, _spec(case, sizes))
    _, info = run_chain(problem, observed_for(case, sizes), sizes, seed)
    info.update(case=name, commit=git_commit())
    path = Path(out_dir) / f"{name}_seed{seed}.json"
    path.write_text(json.dumps(info, indent=1) + "\n")
    print(f"wrote {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="+", choices=sorted(CASES))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicate", action="store_true",
                    help="the JAX chain alone with --seed at the reference "
                    "chain's length, its summary written as "
                    "<case>_seed<seed>.json: the JAX package's own "
                    "chain-to-chain spread")
    args = ap.parse_args(argv)
    if args.replicate:
        for name in args.cases:
            replicate(name, args.seed, args.out)
        return 0
    for name in args.cases:
        case = CASES[name]
        # mc holds O(draws) intermediates per walker: chunks of 16
        chunk = 16 if case["sampling"] == "mc" else None
        thetas = (None if case["chain"]
                  else thetas_of(case["thetas_from"], args.out))
        meta, arrays = reference_case(name, Sizes(chunk=chunk),
                                      thetas=thetas, seed=args.seed)
        write_case(meta, arrays, args.out)
        print(f"wrote {args.out}/{name}.npz, .json", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
