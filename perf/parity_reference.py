"""The JAX package's side of the port's posterior parity, on the CPU.

For each case of ``mcmctoffitting_tpu_torch.utils.parity.CASES`` this
writes ``perf/parity/<case>.npz`` and a readable ``<case>.json``:

* the observed runs, made by the JAX package's
  ``utils/data_io.py::synthesize_observed`` from the key that ``bench.py``
  uses (``fold_in(threefry key 0, 9)``); simultFit at bench's truth, from
  the counts problem, the same arrays for every simultFit case; oneBD at
  its CLI's synthetic truth; the simple family as ``cli/simple_tof.py``
  synthesizes it at seed 0 (10,000 TOFs at the model's truth);
* the spec fields that define the case and the git commit;
* for a case with a chain: the JAX DE chain (the package's ``init_state``
  / ``run_mcmc(..., move='de')`` from its ``initial_walkers_from_observed``,
  or the simple CLI's start, truth x 1.02 + 0.01 N(0, 1)):
  a burn-in of at least 300 steps that goes on while the ensemble's median
  log-prob still rises by more than 1 nat a block of 100, then main
  blocks until every parameter has ESS >= ``min_ess`` (or the cap),
  and kept as its summary only: per parameter the 16/50/84 percentiles,
  the median's standard errors (the tool's and the batch medians'), tau
  and ESS, with acceptance, steps and walkers; the batch medians (B, D)
  go in the ``.npz`` as ``chain_block_medians``;
* 48 thetas drawn from the chain's retained samples (rng seed 11, as in
  ``tools/parity_density_check.py``); the mc and faithful cases take the
  thetas of ``simult_counts`` (the same posterior);
* the JAX log-prob at each theta: mean and standard deviation over the
  finite ones of 16 keys and how many were finite (``lp_n_finite``; the
  faithful likelihood gives -inf), or for 'expected' its value and
  ``jax.grad``.

For each case of ``PT_CASES``: ``cli/shifting_gaussian.py``'s parallel
tempering (its keys, seed 0's data, seeds 0.. for the sampler), ln Z by
thermodynamic integration per seed and the cold chains' pooled summary.

Usage (full width: 200k draws, the presets' F, 256 walkers):

    JAX_PLATFORMS=cpu PYTHONPATH=. python perf/parity_reference.py <case> [...]

``simult_counts`` must exist before the cases that take its thetas.  On
an 8-core host the simultFit chains take 10-16 min, oneBD's 1.8 h (its
ensemble accepts ~0.1% of its moves), the mc density tables 3 and 9 min.
``--replicate --seed N`` runs a case's chain alone and writes its summary
as ``<case>_seed<N>.json`` at the reference chain's length: the JAX
package's own chain-to-chain spread.  ``--rechain --seed N`` runs the
reference's (or that replicate's) chain again at its seed and lengths,
checks that every median is the file's bit for bit, and adds what the
file lacks (the batch-median SE, the block medians); ``--chain-dir``
keeps the chain, and ``--from-chain`` redoes that step from a kept one.
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
                                                   PT_CASES, block_medians,
                                                   chain_summary,
                                                   finite_stats,
                                                   param_names)

OUT = REPO / "perf" / "parity"
SPEC_FIELDS = ("transport", "rk4_substeps", "zero_degree", "cell_attenuation",
               "add_half_zero_deg", "beam_source", "bg_mode", "n_samples",
               "rint_draws", "n_redraw_rounds", "xs_mode", "e0_grid_fine",
               "sampling", "e0_mean_mode", "moment_closure", "a_dtype")
SIMPLE_SPEC_FIELDS = ("poly_order", "sigma_growth", "xs_weighting",
                      "convolve_beam", "bethe_transport", "add_half_zero_deg",
                      "n_samples", "rk4_substeps", "n_transport_bins")
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
    density_chunk: int | None = None   # the density table's (or chunk)


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
    likelihood = case.get("likelihood", "poisson")
    if case["model"] == "simult":
        return simult.SimultFitProblem(spec, n_runs=sizes.n_runs or 4,
                                       likelihood=likelihood)
    return onebd.OneBDProblem(spec, n_runs=sizes.n_runs or 3,
                              likelihood=likelihood)


def _simple(case: dict, sizes: Sizes):
    """(spec, standoff, problem, cfg) as the JAX ``cli/simple_tof.py``
    builds them for ``case['simple_model']`` at ``sizes.n_draws``."""
    from mcmctoffitting_tpu.cli.simple_tof import MODEL_CONFIGS
    from mcmctoffitting_tpu.constants import TUNL_SSA_CSI, TofWindow
    from mcmctoffitting_tpu.models.simple import SimpleProblem, SimpleSpec
    from mcmctoffitting_tpu.ops.stopping import d2_gas_stopping

    model = case["simple_model"]
    cfg = MODEL_CONFIGS[model]
    window = (TofWindow(175.0, 200.0, 25) if model == "v0"
              else TofWindow(175.0, 225.0, 50))
    spec = SimpleSpec(
        window=window, poly_order=cfg.get("poly_order", 1),
        sigma_growth=cfg.get("sigma_growth", False),
        xs_weighting=cfg.get("xs", False),
        convolve_beam=cfg.get("conv", False),
        bethe_transport=cfg.get("bethe", False),
        stopping=d2_gas_stopping(rho=8.37e-5) if cfg.get("bethe") else None,
        add_half_zero_deg=model != "v0", n_samples=sizes.n_draws)
    standoff = (TUNL_SSA_CSI.cell_to_zero if model == "v0"
                else TUNL_SSA_CSI.standoff_mid)
    problem = SimpleProblem(spec=spec, standoff=standoff,
                            param_lo=cfg["lo"], param_hi=cfg["hi"])
    return spec, standoff, problem, cfg


def observed_for(case: dict, sizes: Sizes):
    """bench.py's synthetic data: simultFit from its counts problem at
    bench's truth, oneBD at its CLI's truth; the simple family's as its
    CLI makes it at seed 0 (made once per process)."""
    if case["model"] == "simple":
        return _simple_observed(case["simple_model"], sizes)
    return _synthesize(case["model"], case.get("hardcore", False), sizes)


@functools.lru_cache(maxsize=None)
def _simple_observed(model: str, sizes: Sizes):
    """``cli/simple_tof.py``'s fake data at seed 0: the first 10,000 TOFs
    drawn at the model's truth, histogrammed in its window; one run."""
    from mcmctoffitting_tpu.models.simple import sample_tof

    spec, standoff, _, cfg = _simple({"simple_model": model}, sizes)
    key = jax.random.PRNGKey(0)
    tofs, _, _, _ = sample_tof(jax.random.fold_in(key, 0),
                               jnp.asarray(np.asarray(cfg["truth"])), spec,
                               standoff)
    w = spec.window
    observed, _ = np.histogram(np.asarray(tofs)[:10_000], w.n_bins, w.range)
    return (observed.astype(np.float64),)


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


def run_chain(problem, observed, sizes: Sizes, seed: int, log=print, *,
              names=None, init=None):
    """The JAX DE chain: burn-in, then main blocks until every parameter's
    ESS >= ``sizes.min_ess`` (or ``sizes.max_main`` steps).  ``init(key,
    walkers)``: the initial walkers (default the problem's
    ``initial_walkers_from_observed``); ``observed`` is what the problem's
    ``make_log_prob_fn`` takes."""
    if names is None:
        names = param_names("simult" if isinstance(problem, simult.
                                                   SimultFitProblem)
                            else "onebd", problem.n_runs)
    lb = make_logp_batch(problem.make_log_prob_fn(observed),
                         chunk=sizes.chunk)
    key = jax.random.PRNGKey(seed)
    if init is None:
        p0 = problem.initial_walkers_from_observed(
            jax.random.fold_in(key, 1), sizes.walkers, observed)
    else:
        p0 = init(jax.random.fold_in(key, 1), sizes.walkers)
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
    """Mean and standard deviation of the log-prob over the finite ones of
    ``repeats`` keys at each theta, and their number (one jitted batched
    call)."""
    n, r = thetas.shape[0], sizes.repeats
    rows = jnp.asarray(np.tile(thetas, (r, 1)))
    keys = jax.random.split(jax.random.PRNGKey(seed), n * r)
    lb = jax.jit(make_logp_batch(problem.make_log_prob_fn(observed),
                                 chunk=sizes.density_chunk or sizes.chunk))
    lp = np.asarray(lb(rows, keys), np.float64).reshape(r, n).T
    return finite_stats(lp)


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


def _case_setup(case: dict, sizes: Sizes):
    """(problem, observed as its log-prob takes it, observed runs, meta
    fields, chain keywords) of a case."""
    if case["model"] == "simple":
        spec, standoff, problem, cfg = _simple(case, sizes)
        runs = observed_for(case, sizes)
        center = np.asarray(cfg["truth"]) * 1.02
        names = param_names("simple", 1, cfg["n_dim"])

        def init(key, walkers):
            return (jnp.asarray(center)
                    + 1e-2 * jax.random.normal(key, (walkers, cfg["n_dim"])))

        meta = {"n_runs": 1, "simple_model": case["simple_model"],
                "names": names, "standoff": standoff,
                "window": [spec.window.lo, spec.window.hi,
                           spec.window.n_bins],
                "init_center": center.tolist(), "init_scale": 1e-2,
                "spec_fields": {f: getattr(spec, f)
                                for f in SIMPLE_SPEC_FIELDS}}
        return problem, runs[0], runs, meta, {"names": names, "init": init}
    spec = _spec(case, sizes)
    problem = _problem(case, sizes, spec)
    runs = observed_for(case, sizes)
    meta = {"n_runs": problem.n_runs, "fine_grid": sizes.fine_grid,
            "transport": spec.transport, "xs_mode": spec.xs_mode,
            "hardcore": case.get("hardcore", False),
            "rint_draws": spec.rint_draws,
            "spec_fields": {f: getattr(spec, f) for f in SPEC_FIELDS}}
    return problem, runs, runs, meta, {}


def reference_case(name: str, sizes: Sizes = Sizes(), *, thetas=None,
                   seed: int = 0, log=print):
    """One case's reference: (meta dict, arrays dict).  The JAX chain runs
    when the case has one and no ``thetas`` are given; a case without a
    chain of its own needs ``thetas``."""
    case = CASES[name]
    t0 = time.time()
    problem, observed, runs, fields, chain_kw = _case_setup(case, sizes)
    meta = {"case": name, "model": case["model"], "n_draws": sizes.n_draws,
            "sampling": case["sampling"],
            "likelihood": case.get("likelihood", "poisson"), **fields,
            "jax_version": jax.__version__, "commit": git_commit(),
            "platform": jax.devices()[0].platform,
            "theta_seed": THETA_SEED, "thetas_from": case["thetas_from"]}
    arrays = {f"observed_{r}": np.asarray(o, np.float64)
              for r, o in enumerate(runs)}
    chain = None
    if case["chain"] and thetas is None:
        log(f"{name}: JAX DE chain, {sizes.walkers} walkers")
        chain, meta["chain"] = run_chain(problem, observed, sizes, seed, log,
                                         **chain_kw)
        arrays["chain_block_medians"] = block_medians(chain)
    if thetas is None:
        if chain is None:
            raise ValueError(f"{name} has no chain: pass the thetas of "
                             f"{case['thetas_from']}")
        thetas = draw_thetas(chain, sizes.n_thetas)
    thetas = np.asarray(thetas, np.float32)
    arrays["thetas"] = thetas
    t1 = time.time()
    if case["sampling"] == "expected":
        arrays["lp"], arrays["grad"] = value_and_grad(problem, observed,
                                                      thetas)
    else:
        meta["repeats"] = sizes.repeats
        (arrays["lp_mean"], arrays["lp_sd"],
         arrays["lp_n_finite"]) = density_table(problem, observed, thetas,
                                                sizes, seed + 7)
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
    as its summary and batch medians: ``perf/posterior_parity.py`` sets
    its dz table against the reference chain beside the port's.  Its
    length is fixed, not stopped by the reference's ESS rule: on a chain
    whose tau is long against its length the ESS estimate reaches the
    target early, and the two chains would not compare at the same
    length."""
    ref = json.loads((Path(out_dir) / f"{name}.json").read_text())["chain"]
    chain, info = _fixed_length_chain(name, seed, ref)
    info.update(case=name, commit=git_commit(),
                block_medians=block_medians(chain).tolist())
    path = Path(out_dir) / f"{name}_seed{seed}.json"
    path.write_text(json.dumps(info, indent=1) + "\n")
    print(f"wrote {path}", flush=True)


def _fixed_length_chain(name: str, seed: int, recorded: dict):
    """The case's JAX chain at ``seed`` with the burn-in and main steps of
    ``recorded`` (a chain's info)."""
    case = CASES[name]
    burn, main = recorded["burnin"], recorded["main"]
    sizes = Sizes(burnin=burn, max_burnin=burn, main=main, max_main=main,
                  min_ess=np.inf, walkers=recorded["walkers"])
    problem, observed, _, _, chain_kw = _case_setup(case, sizes)
    return run_chain(problem, observed, sizes, seed, **chain_kw)


def rerun_chain(name: str, seed: int, out_dir=OUT, chain_dir=None):
    """A case's JAX chain run again at the seed, burn-in and main steps
    its file records: the reference chain (``<case>.json``) when ``seed``
    is its seed, else the replicate ``<case>_seed<seed>.json``.  JAX on
    the CPU is reproducible, so it is the same chain; the retained chain
    is saved as ``<chain_dir>/<case>_seed<seed>.npy`` when ``chain_dir``
    is given, and :func:`resummarize` adds to the file what the first
    run did not keep."""
    path = _chain_file(name, seed, out_dir)
    chain, _ = _fixed_length_chain(
        name, seed, _chain_info(json.loads(path.read_text())))
    keep_chain(chain_dir, f"{name}_seed{seed}", chain)
    resummarize(name, seed, chain, out_dir)


def same_summary(old: dict, chain, names, label: str) -> dict:
    """Today's ``chain_summary`` of ``chain`` after checking that every
    field of ``old`` (a file's summary) is the same bit for bit, the
    batch SE aside (the estimator's, not the chain's): so that it is the
    chain the file was made from."""
    summ = chain_summary(chain, names)
    for pname, fields in old.items():
        for field, value in fields.items():
            if not field.startswith("batch_") and summ[pname][field] != value:
                raise ValueError(f"{label}: {pname} {field} "
                                 f"{summ[pname][field]!r} != {value!r}: "
                                 "not the same chain")
    return summ


def resummarize(name: str, seed: int, chain, out_dir=OUT):
    """Rewrite the summary of a case's chain (``chain``, retained (S, W,
    D), the one its file records at ``seed``) with today's
    ``chain_summary`` (:func:`same_summary`); the reference's thetas must
    also be redrawn equal.  Adds the batch medians: the reference's to
    its ``.npz`` (``chain_block_medians``), a replicate's to its JSON."""
    out_dir = Path(out_dir)
    path = _chain_file(name, seed, out_dir)
    doc = json.loads(path.read_text())
    info = _chain_info(doc)
    ref = json.loads((out_dir / f"{name}.json").read_text())
    names = ref.get("names") or param_names(ref["model"], ref["n_runs"])
    info["summary"] = same_summary(info["summary"], chain, names, path.name)
    info["resummarized_at"] = git_commit()
    if path.name == f"{name}.json":
        npz = out_dir / f"{name}.npz"
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        if not np.array_equal(draw_thetas(chain, len(arrays["thetas"])),
                              arrays["thetas"]):
            raise ValueError(f"{name}: the thetas redrawn differ")
        arrays["chain_block_medians"] = block_medians(chain)
        np.savez_compressed(npz, **arrays)
    else:
        info["block_medians"] = block_medians(chain).tolist()
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"{path.name}: every median equal to the file's; batch SE and "
          "block medians written", flush=True)


def keep_chain(chain_dir, stem: str, chain) -> None:
    """Save a retained chain as ``<chain_dir>/<stem>.npy`` (for
    ``--from-chain``) when ``chain_dir`` is given."""
    if chain_dir is not None:
        Path(chain_dir).mkdir(parents=True, exist_ok=True)
        np.save(Path(chain_dir) / f"{stem}.npy", chain)


def _chain_file(name: str, seed: int, out_dir) -> Path:
    ref = Path(out_dir) / f"{name}.json"
    if json.loads(ref.read_text())["chain"]["seed"] == seed:
        return ref
    return Path(out_dir) / f"{name}_seed{seed}.json"


def _chain_info(doc: dict) -> dict:
    return doc["chain"] if "chain" in doc else doc


# ---- HMC at the flagship CLIs' settings -------------------------------------

def hmc_reference(name: str = "simult_expected", chains: int = 32,
                  warmup: int = 400, steps: int = 200, seed: int = 0,
                  out_dir=OUT, log=print, chain_dir=None):
    """The JAX package's HMC on a case's posterior as its
    ``cli/_driver.py::run_gradient_sampler`` runs it (box-logit
    coordinates, the initial-walker law, ``hmc_sample``'s defaults; the
    CLI's -nBurninSteps 400), ``chains`` chains: ``<case>_hmc.json``, the
    chain's summary, split R-hat, step size and acceptance, which
    ``perf/posterior_parity.py`` sets the port's HMC at the same settings
    against.  Where the file exists, the run must give its summary bit
    for bit (:func:`same_summary`); ``chain_dir`` keeps the chain as
    ``<case>_hmc.npy`` (``--from-chain``: :func:`resummarize_hmc`)."""
    from mcmctoffitting_tpu_torch.utils.diagnostics import split_rhat

    case = CASES[name]
    problem, observed, _, fields, _ = _case_setup(case, Sizes())
    names = param_names(case["model"], fields["n_runs"])
    t0 = time.time()
    pos, out, _ = jax_hmc(problem, observed, chains, warmup, steps, seed)
    keep_chain(chain_dir, f"{name}_hmc", pos)
    path = Path(out_dir) / f"{name}_hmc.json"
    if path.exists():
        same_summary(json.loads(path.read_text())["summary"], pos, names,
                     path.name)
        log(f"{path.name}: every median equal to the file's")
    info = {"case": name, "sampler": "hmc", "chains": chains,
            "warmup": warmup, "steps": steps,
            "step_size": float(out.step_size),
            "accept_prob": float(np.mean(np.asarray(out.accept_prob))),
            "split_rhat": split_rhat(pos).tolist(),
            "seconds": time.time() - t0, "seed": seed,
            "summary": chain_summary(pos, names),
            "block_medians": block_medians(pos).tolist(),
            "jax_version": jax.__version__, "commit": git_commit()}
    path.write_text(json.dumps(info, indent=1) + "\n")
    log(f"{name}: JAX HMC {chains} chains x {warmup} + {steps}: step size "
        f"{info['step_size']:.4g}, split R-hat max "
        f"{max(info['split_rhat']):.3f}, {info['seconds']:.0f} s")
    return info


def jax_hmc(problem, observed, chains: int, warmup: int, steps: int,
            seed: int):
    """The JAX package's ``hmc_sample`` with its defaults on ``problem``'s
    'expected' log-prob in box-logit coordinates, from the first
    ``chains`` of 256 (or more) walkers of its
    ``initial_walkers_from_observed``: (chain (S, C, D) float64 in theta,
    the sampler's output, the start (C, D) in theta)."""
    from mcmctoffitting_tpu.sampler.hmc import hmc_sample
    from mcmctoffitting_tpu.sampler.transforms import BoxLogitTransform

    logp_full = problem.make_log_prob_fn(observed)
    key = jax.random.PRNGKey(seed)
    key0 = jax.random.fold_in(key, 7)
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi)
    logp_u = tr.wrap_logp(lambda theta: logp_full(theta, key0))
    cloud = np.asarray(problem.initial_walkers_from_observed(
        jax.random.fold_in(key, 3), max(256, chains), observed))[:chains]
    p0 = tr.to_u(jnp.asarray(cloud, jnp.float32))
    out = hmc_sample(jax.random.fold_in(key, 2), p0, steps, logp_u,
                     n_warmup=warmup)
    return (np.asarray(tr.to_theta(out.positions), np.float64), out,
            np.asarray(cloud, np.float32))


def resummarize_hmc(name: str, chain, out_dir=OUT):
    """``<case>_hmc.json``'s summary and block medians from a kept chain
    (:func:`same_summary`)."""
    path = Path(out_dir) / f"{name}_hmc.json"
    doc = json.loads(path.read_text())
    names = list(doc["summary"])
    doc["summary"] = same_summary(doc["summary"], chain, names, path.name)
    doc["block_medians"] = block_medians(chain).tolist()
    doc["resummarized_at"] = git_commit()
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"{path.name}: every median equal to the file's; batch SE and "
          "block medians written", flush=True)


# ---- the evidence cases (PT_CASES) -----------------------------------------

SG_TRUTH = (0.4, -0.3, 5.0)        # cli/shifting_gaussian.py's TRUTH


def pt_setup(case: dict):
    """(observed arrays, loglike, logprior, initial-walker function of
    (key, T, W), names, meta fields) of an evidence case, as the JAX
    ``cli/shifting_gaussian.py`` builds them at ``-seed 0``; the meta
    fields of ``-model tof`` are its spec's ``SPEC_FIELDS``, which the
    port's side checks."""
    from mcmctoffitting_tpu.ops.likelihoods import box_lnprior

    key = jax.random.PRNGKey(0)
    if case["model"] == "analytic":
        from mcmctoffitting_tpu.models import shifting_gaussian as sg

        data = sg.generate_data(jax.random.fold_in(key, 0), 500, *SG_TRUTH)
        loglike, logprior = sg.make_pt_fns(data, numeric=True)

        def init(k, t, w):
            return (jnp.asarray(SG_TRUTH)
                    + 1e-3 * jax.random.normal(k, (t, w, 3)))

        return ((np.asarray(data),), loglike, logprior, init,
                ["sigma", "m", "b"], {})
    spec = simult.default_spec(n_samples=50_000, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=2, likelihood="poisson")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(2, 5.0e4)])
    observed = data_io.synthesize_observed(jax.random.fold_in(key, 9),
                                           problem, truth)
    obs = tuple(jnp.asarray(o, jnp.float32) for o in observed)

    def loglike(theta, k):
        return problem.log_like(theta, k, obs)

    def logprior(theta, k):
        return box_lnprior(theta, problem.param_lo, problem.param_hi,
                           inclusive=True)

    def init(k, t, w):
        return problem.initial_walkers_from_observed(
            k, t * w, observed).reshape(t, w, problem.n_dim)

    return (tuple(np.asarray(o) for o in observed), loglike, logprior, init,
            param_names("simult", 2),
            {"spec_fields": {f: getattr(spec, f) for f in SPEC_FIELDS}})


def pt_seed(case: dict, setup, seed: int):
    """One seed of the CLI's PT phase: (ln Z, d ln Z, cold chain (S, W, D),
    swap acceptance, seconds).  The analytic branch's keys are the CLI's
    (walkers 3, burn-in 4, main 5), the TOF branch's (1, 2, 3)."""
    from mcmctoffitting_tpu.sampler.pt import sample_pt

    _, loglike, logprior, init, _, _ = setup
    key = jax.random.PRNGKey(seed)
    tof = case["model"] == "tof"
    k_init, k_burn, k_main = (1, 2, 3) if tof else (3, 4, 5)
    t0 = time.time()
    p0 = init(jax.random.fold_in(key, k_init), case["temps"],
              case["walkers"])
    burn = sample_pt(jax.random.fold_in(key, k_burn), p0, case["burnin"],
                     loglike, logprior, stochastic=tof, move="stretch")
    chain = sample_pt(jax.random.fold_in(key, k_main),
                      burn.state.positions, case["steps"], loglike,
                      logprior, thin=case["thin"], stochastic=tof,
                      move="stretch")
    ln_z, d_ln_z = chain.thermodynamic_integration_log_evidence()
    swaps = (np.asarray(chain.n_swaps_accepted) / case["steps"]
             / case["walkers"])
    return (float(ln_z), float(d_ln_z), np.asarray(chain.cold_chain),
            swaps.tolist(), time.time() - t0)


def pt_reference(name: str, out_dir=OUT, log=print, *,
                 case: dict | None = None, chain_dir=None):
    """An evidence case's reference: ``<case>.npz`` (the observed arrays,
    ln Z per seed, the pooled cold chain's batch medians) and
    ``<case>.json`` (the case, its spec fields, per seed ln Z, its
    trapezoid-halving error, swap acceptance and seconds, and the pooled
    cold chains' summary).  ``case`` overrides ``PT_CASES[name]``
    (smaller sizes).  Where the file exists, every ln Z and the cold
    summary must come out bit for bit (:func:`same_summary`);
    ``chain_dir`` keeps the pooled cold chain as ``<case>_cold.npy``
    (``--from-chain``: :func:`resummarize_pt`)."""
    case = case or PT_CASES[name]
    n = case["seeds"]
    setup = pt_setup(case)
    observed, names, fields = setup[0], setup[4], setup[5]
    runs, colds = [], []
    for seed in range(n):
        ln_z, d_ln_z, cold, swaps, secs = pt_seed(case, setup, seed)
        colds.append(cold)
        runs.append({"seed": seed, "ln_z": ln_z, "d_ln_z": d_ln_z,
                     "swap_acceptance": swaps, "seconds": secs})
        log(f"{name} seed {seed}: ln Z {ln_z:.4f} +- {d_ln_z:.4f} "
            f"(trapezoid halving), {secs:.0f} s")
    pooled = np.concatenate(colds, axis=1)          # (S, n W, D)
    keep_chain(chain_dir, f"{name}_cold", pooled)
    old = Path(out_dir) / f"{name}.json"
    if old.exists():
        old = json.loads(old.read_text())
        if [r["ln_z"] for r in old["runs"]] != [r["ln_z"] for r in runs]:
            raise ValueError(f"{name}: ln Z differs from the file's")
        same_summary(old["cold_summary"], pooled, names, f"{name}.json")
        log(f"{name}: every ln Z and median equal to the file's")
    meta = {"case": name, **{k: v for k, v in case.items()
                             if k not in ("kernels",)}, **fields,
            "cut": {"burnin": case["burnin"], "steps": case["steps"],
                    "thin": case["thin"], "cli": [1000, 10_000, 10]},
            "names": names, "n_runs": len(observed), "seeds_run": n,
            "runs": runs, "cold_summary": chain_summary(pooled, names),
            "jax_version": jax.__version__, "commit": git_commit(),
            "platform": jax.devices()[0].platform}
    arrays = {f"observed_{r}": np.asarray(o, np.float64)
              for r, o in enumerate(observed)}
    arrays["ln_z"] = np.array([r["ln_z"] for r in runs])
    arrays["cold_block_medians"] = block_medians(pooled)
    write_case(meta, arrays, out_dir)
    return meta, arrays


def resummarize_pt(name: str, pooled, out_dir=OUT):
    """An evidence case's cold summary and batch medians from its kept
    pooled cold chain (:func:`same_summary`)."""
    out_dir = Path(out_dir)
    path = out_dir / f"{name}.json"
    meta = json.loads(path.read_text())
    meta["cold_summary"] = same_summary(meta["cold_summary"], pooled,
                                        meta["names"], path.name)
    meta["resummarized_at"] = git_commit()
    npz = out_dir / f"{name}.npz"
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["cold_block_medians"] = block_medians(pooled)
    np.savez_compressed(npz, **arrays)
    path.write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{path.name}: every median equal to the file's; batch SE and "
          "block medians written", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="+", choices=sorted([*CASES, *PT_CASES]))
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicate", action="store_true",
                    help="the JAX chain alone with --seed at the reference "
                    "chain's length, its summary written as "
                    "<case>_seed<seed>.json: the JAX package's own "
                    "chain-to-chain spread")
    ap.add_argument("--rechain", action="store_true",
                    help="run the chain the file records at --seed again, "
                    "check its medians against the file's and add the "
                    "batch-median SE and block medians")
    ap.add_argument("--chain-dir", default=None,
                    help="with --rechain, --hmc or an evidence case: keep "
                    "the chain there (<case>_seed<seed>.npy, "
                    "<case>_hmc.npy, <case>_cold.npy)")
    ap.add_argument("--from-chain", default=None,
                    help="the summary step of --rechain, --hmc or an "
                    "evidence case from a kept chain (.npy)")
    ap.add_argument("--hmc", type=int, default=None, metavar="CHAINS",
                    help="the JAX package's HMC on the case at the CLI's "
                    "settings with CHAINS chains (<case>_hmc.json)")
    args = ap.parse_args(argv)
    for name in args.cases:
        if name in PT_CASES and args.from_chain:
            resummarize_pt(name, np.load(args.from_chain), args.out)
        elif name in PT_CASES:
            pt_reference(name, out_dir=args.out, chain_dir=args.chain_dir)
            print(f"wrote {args.out}/{name}.npz, .json", flush=True)
        elif args.hmc and args.from_chain:
            resummarize_hmc(name, np.load(args.from_chain), args.out)
        elif args.hmc:
            hmc_reference(name, args.hmc, seed=args.seed, out_dir=args.out,
                          chain_dir=args.chain_dir)
        elif args.from_chain:
            resummarize(name, args.seed, np.load(args.from_chain), args.out)
        elif args.rechain:
            rerun_chain(name, args.seed, args.out, args.chain_dir)
        elif args.replicate:
            replicate(name, args.seed, args.out)
        else:
            case = CASES[name]
            # mc holds O(draws) intermediates per walker: chunks of 16
            # (the simple family's chain evaluates 50 a half-step at once)
            mc = case["sampling"] == "mc"
            sizes = Sizes(chunk=16 if mc and not case["chain"] else None,
                          density_chunk=16 if mc else None,
                          walkers=case.get("walkers", 256))
            thetas = (None if case["chain"]
                      else thetas_of(case["thetas_from"], args.out))
            meta, arrays = reference_case(name, sizes, thetas=thetas,
                                          seed=args.seed)
            write_case(meta, arrays, args.out)
            print(f"wrote {args.out}/{name}.npz, .json", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
