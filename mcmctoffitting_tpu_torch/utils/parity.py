"""Posterior-level parity of the port against the JAX package.

Two protocols, the JAX system's own, as functions that the perf script
(``perf/posterior_parity.py``), ``chip_smoke.py`` and the tests share:

* **density** (``tools/parity_density_check.py:48-140``): both packages'
  log-posteriors at the same thetas.  If they define the same density,
  the difference Delta(theta) = logp_port - logp_jax is constant in theta
  (an additive constant aside); its centred spread is the disagreement in
  nats.  The stochastic estimators are evaluated R times at each theta on
  both sides (different random streams: only means and standard
  deviations compare).  Gates: the JAX tool's ``spread < max(5 x noise,
  1 nat)``, with the noise the standard deviation that Monte-Carlo noise
  alone gives each Delta_i, and a chi-square gate on the centred
  Delta_i in units of their own standard errors.  The deterministic
  'expected' estimator gets a spread tolerance in nats and a relative L2
  tolerance on the gradient per theta instead.
* **dz** (``tools/reference_posterior_parity.py:378-440``, ``_median_se``
  and ``report``): per parameter, the medians' difference in pooled
  posterior sigmas (dz) and in the medians' own autocorrelation-corrected
  standard errors (z_se).

And the port's side of a parity case: the problem built from the spec
fields a reference file names (``perf/parity_reference.py`` writes them,
with the JAX package's observed arrays), and the case table.  numpy and
torch only: nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .diagnostics import integrated_autocorr_time

# chain-level gates (worst over the parameters)
DZ_MAX = 0.25
Z_SE_MAX = 4.0
# the JAX tool's density gate: spread < max(NOISE_FACTOR x noise, NATS_FLOOR)
NOISE_FACTOR = 5.0
NATS_FLOOR = 1.0
# 'expected' (deterministic on both sides): the centred spread of Delta
# in nats and the gradient's relative L2 error at each theta, fixed from
# the CPU-against-JAX numbers before the first card run; and the median
# of that error over the thetas, set from the CPU and card readings so
# that a gradient a few percent off fails (PERF.md)
EXPECTED_SPREAD_NATS = 0.25
EXPECTED_GRAD_REL_L2 = 0.25
EXPECTED_GRAD_REL_L2_MEDIAN = 1e-2

# The parity cases: the forward each one runs, where its thetas come
# from (its own JAX chain, or another case's), and the kernels on its
# path.  Every case takes the corrected likelihood.
CASES = {
    "simult_counts": dict(model="simult", sampling="counts",
                          transport="table", xs_mode="e0grid",
                          chain=True, thetas_from="simult_counts",
                          kernels=("poisson", "tof_hist")),
    "onebd_hardcore_counts": dict(model="onebd", sampling="counts",
                                  hardcore=True, chain=True,
                                  thetas_from="onebd_hardcore_counts",
                                  kernels=("poisson", "tof_hist")),
    "simult_mc": dict(model="simult", sampling="mc", transport="table",
                      xs_mode="e0grid", chain=False,
                      thetas_from="simult_counts", kernels=("tof_hist",)),
    "simult_mc_rk4_taylor": dict(model="simult", sampling="mc",
                                 transport="rk4", xs_mode="taylor",
                                 chain=False, thetas_from="simult_counts",
                                 kernels=("transport_moments", "tof_hist")),
    "simult_expected": dict(model="simult", sampling="expected",
                            transport="table", xs_mode="e0grid",
                            rint_draws=False, chain=True,
                            thetas_from="simult_expected",
                            kernels=("tof_hist", "K2-bwd")),
}
# the cases whose port side runs a DE chain against the JAX chain (the
# 'expected' JAX chain is held against the port's NUTS instead)
DE_CHAIN_CASES = tuple(name for name, case in CASES.items()
                       if case["chain"] and case["sampling"] == "counts")
SIMULT_NAMES = ("beamE", "eLoss", "scale", "s")
ONEBD_NAMES = ("eLoss", "scale", "s")


def param_names(model: str, n_runs: int) -> list[str]:
    if model == "simult":
        return [*SIMULT_NAMES, *(f"N_{r + 1}" for r in range(n_runs))]
    return [*ONEBD_NAMES, *(f"N_{r + 1}" for r in range(n_runs)),
            *(f"BG_{r + 1}" for r in range(n_runs))]


# ---- dz (chain level) ------------------------------------------------------

def median_se(walker_chain) -> tuple[float, float]:
    """Standard error of the median of an autocorrelated ensemble chain,
    and its ESS: ``walker_chain`` (S, W), one parameter.  ESS = S W / tau
    with tau the ensemble-mean integrated autocorrelation time;
    SE(median) ~ 1.2533 sigma / sqrt(ESS), sigma the 16/84 half-width."""
    walker_chain = np.asarray(walker_chain, np.float64)
    s, w = walker_chain.shape
    tau = float(integrated_autocorr_time(walker_chain[:, :, None]).max())
    ess = s * w / max(tau, 1.0)
    q = np.percentile(walker_chain.reshape(-1), [16, 84])
    sigma = 0.5 * (q[1] - q[0])
    return 1.2533 * sigma / np.sqrt(max(ess, 1.0)), ess


def chain_summary(chain, names) -> dict:
    """Per-parameter 16/50/84 percentiles, ``median_se``, tau and ESS of a
    retained (S, W, D) chain: what a reference file keeps of a chain."""
    chain = np.asarray(chain, np.float64)
    s, w, _ = chain.shape
    out = {}
    for d, name in enumerate(names):
        q16, q50, q84 = np.percentile(chain[:, :, d].reshape(-1),
                                      [16, 50, 84])
        se, ess = median_se(chain[:, :, d])
        out[name] = {"q16": float(q16), "q50": float(q50),
                     "q84": float(q84), "median_se": float(se),
                     "ess": float(ess), "tau": float(s * w / ess)}
    return out


def between_chain_ess(chain) -> np.ndarray:
    """Per-parameter ESS of C independent chains, (S, C, D), from the
    spread of their means: C sigma^2 / var(chain means).  It needs no
    S >= 50 tau, as :func:`median_se`'s autocorrelation estimator does
    (on short chains that one's window cuts tau off).  Not for an
    ensemble, whose walkers move together."""
    chain = np.asarray(chain, np.float64)
    c = chain.shape[1]
    means = chain.mean(axis=0)                              # (C, D)
    var = chain.reshape(-1, chain.shape[2]).var(axis=0, ddof=1)
    return c * var / np.maximum(means.var(axis=0, ddof=1), 1e-300)


def dz_table(ref_summary: dict, port_chain, names) -> dict:
    """The dz protocol: per parameter the medians, the 16/84 half-widths,
    dz (the medians' difference in pooled sigmas), z_se (in the medians'
    own standard errors) and both ESS.  ``ref_summary`` is
    :func:`chain_summary` of the reference chain, ``port_chain`` the
    port's retained (S, W, D) chain.  PASS when the worst |dz| <
    ``DZ_MAX`` and the worst |z_se| < ``Z_SE_MAX``."""
    return dz_between(ref_summary, chain_summary(port_chain, names), names)


def dz_between(ref_summary: dict, port: dict, names) -> dict:
    """:func:`dz_table` of two :func:`chain_summary` results."""
    rows = []
    for name in names:
        r, p = ref_summary[name], port[name]
        sig_r = 0.5 * (r["q84"] - r["q16"])
        sig_p = 0.5 * (p["q84"] - p["q16"])
        pooled = np.sqrt(0.5 * (sig_r ** 2 + sig_p ** 2))
        diff = p["q50"] - r["q50"]
        dz = diff / pooled if pooled > 0 else np.inf
        z_se = diff / np.sqrt(r["median_se"] ** 2 + p["median_se"] ** 2)
        rows.append({"param": name, "ref_median": r["q50"],
                     "ref_sigma": sig_r, "port_median": p["q50"],
                     "port_sigma": sig_p, "dz": float(dz),
                     "z_se": float(z_se), "ref_ess": r["ess"],
                     "port_ess": p["ess"]})
    worst_dz = max(abs(row["dz"]) for row in rows)
    worst_se = max(abs(row["z_se"]) for row in rows)
    ok = bool(worst_dz < DZ_MAX and worst_se < Z_SE_MAX)
    return {"rows": rows, "worst_dz": worst_dz, "worst_z_se": worst_se,
            "min_ref_ess": min(row["ref_ess"] for row in rows),
            "min_port_ess": min(row["port_ess"] for row in rows),
            "verdict": "PASS" if ok else "REVIEW",
            "gate": f"|dz| < {DZ_MAX} and |z_se| < {Z_SE_MAX}"}


def format_dz(table: dict, names=("JAX", "port")) -> str:
    """The dz table as text, its two sides named by ``names``."""
    a, b = names
    lines = [f"{'param':>6} {a + ' med':>11} {a + ' sig':>9} "
             f"{b + ' med':>11} {b + ' sig':>9} {'dz':>6} {'z_se':>6} "
             f"{'ESS ' + a:>10} {'ESS ' + b:>10}"]
    for r in table["rows"]:
        lines.append(f"{r['param']:>6} {r['ref_median']:11.5g} "
                     f"{r['ref_sigma']:9.3g} {r['port_median']:11.5g} "
                     f"{r['port_sigma']:9.3g} {r['dz']:6.3f} "
                     f"{r['z_se']:6.2f} {r['ref_ess']:10.0f} "
                     f"{r['port_ess']:10.0f}")
    lines.append(f"worst |dz| {table['worst_dz']:.3f}, worst |z_se| "
                 f"{table['worst_z_se']:.2f} -> {table['verdict']} "
                 f"({table['gate']})")
    return "\n".join(lines)


# ---- density (same theta) ---------------------------------------------------

def chi2_dof_max(n: int) -> float:
    """The chi-square gate's limit for n thetas: 1 + 4 sqrt(2 / (n - 1))."""
    return 1.0 + 4.0 * np.sqrt(2.0 / (n - 1))


def _correlations(thetas, delta, names) -> dict:
    out = {}
    for i, name in enumerate(names):
        col = thetas[:, i]
        if np.std(col) == 0 or np.std(delta) == 0:
            out[name] = 0.0
        else:
            out[name] = round(float(np.corrcoef(col, delta)[0, 1]), 3)
    return out


def density_parity(ref_mean, ref_sd, port_mean, port_sd, repeats, thetas,
                   names) -> dict:
    """The same-theta density check of a stochastic estimator.

    ``ref_mean``/``ref_sd`` (JAX) and ``port_mean``/``port_sd`` are the
    per-theta means and standard deviations of the log-prob over
    ``repeats`` evaluations each.  With Delta_i the difference of the
    means and v_i = (s_p,i^2 + s_J,i^2) / R its Monte-Carlo variance:

    * spread: the centred standard deviation of Delta; noise: sqrt(mean
      v_i), the spread Monte-Carlo noise alone gives; the JAX tool's gate
      spread < max(5 noise, 1 nat);
    * chi2/dof = sum_i (Delta_i - mean Delta)^2 / v_i / (n - 1), gated at
      ``chi2_dof_max(n)``: a systematic theta-dependent offset far below
      the nat floor still fails it.

    PASS when every theta is finite on both sides and both gates hold.
    """
    ref_mean, ref_sd, port_mean, port_sd, thetas = (
        np.asarray(a, np.float64)
        for a in (ref_mean, ref_sd, port_mean, port_sd, thetas))
    n = ref_mean.shape[0]
    finite = (np.isfinite(ref_mean) & np.isfinite(port_mean)
              & np.isfinite(ref_sd) & np.isfinite(port_sd))
    delta = (port_mean - ref_mean)[finite]
    var = ((port_sd ** 2 + ref_sd ** 2) / repeats)[finite]
    m = delta.size
    spread = float(np.std(delta, ddof=1)) if m > 1 else np.inf
    noise = float(np.sqrt(np.mean(var))) if m else np.inf
    chi2 = (float(np.sum((delta - delta.mean()) ** 2
                         / np.maximum(var, 1e-300)) / (m - 1))
            if m > 1 else np.inf)
    spread_ok = spread < max(NOISE_FACTOR * noise, NATS_FLOOR)
    chi2_ok = chi2 <= chi2_dof_max(n)
    ok = bool(m == n and spread_ok and chi2_ok)
    return {
        "n_thetas": n, "n_finite": int(m), "repeats": int(repeats),
        "mean_offset_nats": float(delta.mean()) if m else np.nan,
        "spread_nats": spread, "noise_nats": noise,
        "spread_gate_nats": max(NOISE_FACTOR * noise, NATS_FLOOR),
        "chi2_dof": chi2, "chi2_dof_max": chi2_dof_max(n),
        "ref_sd_median": float(np.median(ref_sd)),
        "port_sd_median": float(np.median(port_sd)),
        "correlations": _correlations(thetas[finite], delta, names),
        "spread_verdict": "PASS" if spread_ok else "REVIEW",
        "chi2_verdict": "PASS" if chi2_ok else "REVIEW",
        "verdict": "PASS" if ok else "REVIEW"}


def expected_parity(ref_lp, port_lp, ref_grad, port_grad, thetas,
                    names) -> dict:
    """The same-theta check of the deterministic 'expected' estimator:
    the centred spread of Delta below ``EXPECTED_SPREAD_NATS``, and the
    gradient's relative L2 error ||g_p - g_J|| / ||g_J|| below
    ``EXPECTED_GRAD_REL_L2`` at every theta and below
    ``EXPECTED_GRAD_REL_L2_MEDIAN`` in the median over the thetas."""
    ref_lp, port_lp, thetas = (np.asarray(a, np.float64)
                               for a in (ref_lp, port_lp, thetas))
    n = ref_lp.shape[0]
    finite = np.isfinite(ref_lp) & np.isfinite(port_lp)
    delta = (port_lp - ref_lp)[finite]
    spread = float(np.std(delta, ddof=1)) if delta.size > 1 else np.inf
    out = {"n_thetas": n, "n_finite": int(finite.sum()),
           "mean_offset_nats": float(delta.mean()) if delta.size else np.nan,
           "spread_nats": spread, "spread_tol_nats": EXPECTED_SPREAD_NATS,
           "correlations": _correlations(thetas[finite], delta, names)}
    ok = bool(finite.all() and spread < EXPECTED_SPREAD_NATS)
    out["spread_verdict"] = "PASS" if ok else "REVIEW"
    if ref_grad is not None:
        ref_grad = np.asarray(ref_grad, np.float64)
        port_grad = np.asarray(port_grad, np.float64)
        rel = (np.linalg.norm(port_grad - ref_grad, axis=-1)
               / np.linalg.norm(ref_grad, axis=-1))
        grad_ok = bool(np.all(rel < EXPECTED_GRAD_REL_L2)
                       and np.median(rel) < EXPECTED_GRAD_REL_L2_MEDIAN)
        out.update({"grad_rel_l2_max": float(np.max(rel)),
                    "grad_rel_l2_median": float(np.median(rel)),
                    "grad_tol": EXPECTED_GRAD_REL_L2,
                    "grad_median_tol": EXPECTED_GRAD_REL_L2_MEDIAN,
                    "grad_verdict": "PASS" if grad_ok else "REVIEW"})
        ok = ok and grad_ok
    out["verdict"] = "PASS" if ok else "REVIEW"
    return out


# ---- the port's side of a case ---------------------------------------------

@dataclasses.dataclass
class Reference:
    """A case's reference file (``perf/parity/<case>.npz`` + ``.json``)."""

    meta: dict            # the JSON: the case, its spec fields, summaries
    observed: tuple       # per-run observed counts (the JAX package's)
    thetas: np.ndarray    # (n, D) float32
    arrays: dict          # lp_mean, lp_sd (stochastic) | lp, grad

    @property
    def names(self) -> list[str]:
        return param_names(self.meta["model"], self.meta["n_runs"])


def load_reference(path) -> Reference:
    """Read ``<case>.npz`` and its ``<case>.json`` beside it."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as z:
        observed = tuple(z[f"observed_{r}"] for r in range(meta["n_runs"]))
        arrays = {k: z[k] for k in z.files
                  if not k.startswith("observed_") and k != "thetas"}
        thetas = z["thetas"]
    return Reference(meta, observed, thetas, arrays)


def build_problem(meta: dict, device):
    """The port's problem for a case's spec fields; its spec must agree
    with the JAX spec's fields that the reference file records."""
    from ..models import onebd, simult

    if meta["model"] == "simult":
        spec = simult.default_spec(meta["n_draws"],
                                   fine_grid=meta["fine_grid"],
                                   transport=meta["transport"],
                                   xs_mode=meta["xs_mode"],
                                   sampling=meta["sampling"])
        cls = simult.SimultFitProblem
    else:
        spec = onebd.default_spec(meta["n_draws"],
                                  fine_grid=meta["fine_grid"],
                                  hardcore=meta["hardcore"],
                                  sampling=meta["sampling"])
        cls = onebd.OneBDProblem
    spec = dataclasses.replace(spec, rint_draws=meta["rint_draws"])
    for field, want in meta["spec_fields"].items():
        got = getattr(spec, field)
        if got != want:
            raise ValueError(f"{meta['case']}: the port's spec has {field} = "
                             f"{got!r}, the reference {want!r}")
    return cls(spec, n_runs=meta["n_runs"], likelihood=meta["likelihood"],
               device=device)


def shifted_thetas(ref: Reference, problem, k: float) -> np.ndarray:
    """The reference's thetas with the first parameter (beamE; eLoss on
    oneBD) moved by ``k`` of its posterior sigma (the reference chain's
    16/84 half-width), each towards the middle of the prior box so that
    none leaves it."""
    summ = ref.meta["chain"]["summary"] if ref.meta.get("chain") else None
    if summ is None:
        raise ValueError(f"{ref.meta['case']} has no chain summary")
    first = ref.names[0]
    sigma = 0.5 * (summ[first]["q84"] - summ[first]["q16"])
    mid = 0.5 * (problem.param_lo[0] + problem.param_hi[0])
    thetas = np.array(ref.thetas, np.float32)
    thetas[:, 0] += np.where(thetas[:, 0] < mid, 1.0, -1.0) * k * sigma
    return thetas


def repeat_log_probs(problem, observed, thetas, repeats: int, seed: int, *,
                     chunk: int = 512) -> np.ndarray:
    """(n, repeats) log-probs of ``thetas`` (n, D), each theta evaluated
    ``repeats`` times with draws of its own: the (repeats x n) rows go
    through ``make_log_prob_fn`` in batches of ``chunk`` rows with one
    host generator seeded by ``seed``."""
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.as_tensor(np.tile(np.asarray(thetas, np.float32),
                                   (repeats, 1)), device=problem.device)
    out = []
    with torch.no_grad():
        for start in range(0, rows.shape[0], chunk):
            out.append(logp(rows[start:start + chunk], gen))
    lp = torch.cat(out).double().cpu().numpy()
    return lp.reshape(repeats, -1).T


def value_and_grad(problem, observed, thetas):
    """The deterministic log-prob and its autograd gradient at ``thetas``
    (n, D): ((n,), (n, D)) float64 numpy."""
    logp = problem.make_log_prob_fn(observed)
    t = torch.as_tensor(np.asarray(thetas, np.float32),
                        device=problem.device).requires_grad_(True)
    with torch.enable_grad():
        lp = logp(t, torch.Generator())
        grad, = torch.autograd.grad(lp.sum(), t)
    return (lp.detach().double().cpu().numpy(),
            grad.double().cpu().numpy())


def density_check(ref: Reference, problem, *, seed: int = 0,
                  thetas=None) -> dict:
    """The port's side of a case's density check at the reference's thetas
    (or at ``thetas``, e.g. shifted ones, against the same reference
    values), judged by :func:`density_parity` or
    :func:`expected_parity`."""
    thetas = ref.thetas if thetas is None else np.asarray(thetas, np.float32)
    names = ref.names
    if ref.meta["sampling"] == "expected":
        lp, grad = value_and_grad(problem, ref.observed, thetas)
        out = expected_parity(ref.arrays["lp"], lp, ref.arrays["grad"],
                              grad, thetas, names)
        out["port_lp"] = lp.tolist()
        return out
    repeats = ref.meta["repeats"]
    lp = repeat_log_probs(problem, ref.observed, thetas, repeats, seed,
                          chunk=256 if ref.meta["sampling"] == "mc" else 512)
    out = density_parity(ref.arrays["lp_mean"], ref.arrays["lp_sd"],
                         lp.mean(1), lp.std(1, ddof=1), repeats, thetas,
                         names)
    out["port_lp_mean"] = lp.mean(1).tolist()
    out["port_lp_sd"] = lp.std(1, ddof=1).tolist()
    return out


def run_port_chain(ref: Reference, problem, *, seed: int = 0):
    """The port's DE chain at the reference chain's walkers and steps, from
    the port's ``initial_walkers_from_observed``: (retained (S, W, D)
    float64 numpy, mean acceptance)."""
    from ..sampler import init_state, run_mcmc

    ch = ref.meta["chain"]
    dev = problem.device
    logp = problem.make_log_prob_fn(ref.observed)
    gen = torch.Generator(dev).manual_seed(seed)
    p0 = problem.initial_walkers_from_observed(gen, ch["walkers"],
                                               ref.observed)
    state = init_state(p0, logp, generator=gen,
                       eval_generator=torch.Generator().manual_seed(seed + 1))
    state = run_mcmc(state, ch["burnin"], logp, move="de").state
    chain = run_mcmc(state, ch["main"], logp, move="de")
    acc = float(chain.acceptance_fraction.float().mean())
    return chain.positions.double().cpu().numpy(), acc
