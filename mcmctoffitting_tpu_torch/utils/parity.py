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
  Delta_i in units of their own standard errors, over the finite
  repeats; how often each side is -inf is a two-proportion test of its
  own (:func:`neg_inf_shares`: the faithful likelihood's -inf walkers).
  The deterministic 'expected' estimator gets a spread tolerance in nats
  and a relative L2 tolerance on the gradient per theta instead.
* **dz** (``tools/reference_posterior_parity.py:378-440``, ``_median_se``
  and ``report``): per parameter, the medians' difference in pooled
  posterior sigmas (dz) and in the medians' own standard errors (z_se).
  The tool's standard error (:func:`median_se`) rests on an
  autocorrelation window that needs chains of ~50 tau and counts the
  walkers as independent; z_se is gated with :func:`batch_median_se`
  instead, which holds at 8 tau and on an ensemble whose walkers move
  together, and the tool's z_se is printed beside it.

And a third, for parallel tempering: **evidence** (:func:`evidence_parity`),
ln Z by thermodynamic integration from several seeds per package, their
means within ``LN_Z_SIGMAS`` of the seeds' spread.

And the port's side of a parity case: the problem built from the spec
fields a reference file names (``perf/parity_reference.py`` writes them,
with the JAX package's observed arrays), and the case tables.  numpy,
scipy and torch only: nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from scipy import stats

from .diagnostics import integrated_autocorr_time

# chain-level gates (worst over the parameters)
DZ_MAX = 0.25
Z_SE_MAX = 4.0
# batch medians: blocks of at least BLOCK_TAUS autocorrelation times as
# the window estimator reads them (about half the true tau on a chain of
# 8 tau; ``chain_taus``), between MIN_BLOCKS and MAX_BLOCKS of them
BLOCK_TAUS = 4.0
MIN_BLOCKS, MAX_BLOCKS = 4, 20
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
# path.  The likelihood is the corrected one ('poisson') unless the case
# names another; 'simple' is the simple family as ``cli/simple_tof.py``
# builds it (``simple_model``), its chain from the CLI's start.
CASES = {
    "simult_counts": dict(model="simult", sampling="counts",
                          transport="table", xs_mode="e0grid",
                          chain=True, thetas_from="simult_counts",
                          kernels=("counts_rates", "poisson", "tof_hist")),
    "onebd_hardcore_counts": dict(model="onebd", sampling="counts",
                                  hardcore=True, chain=True,
                                  thetas_from="onebd_hardcore_counts",
                                  kernels=("counts_rates", "poisson",
                                           "tof_hist")),
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
    "simult_mc_rk4_exact": dict(model="simult", sampling="mc",
                                transport="rk4", xs_mode="exact",
                                chain=False, thetas_from="simult_counts",
                                kernels=("weighted_hist", "tof_hist")),
    "simult_counts_faithful": dict(model="simult", sampling="counts",
                                   transport="table", xs_mode="e0grid",
                                   likelihood="reference", chain=False,
                                   thetas_from="simult_counts",
                                   kernels=("counts_rates", "poisson",
                                            "tof_hist")),
    "simple_v2": dict(model="simple", simple_model="v2", sampling="mc",
                      walkers=100, chain=True, thetas_from="simple_v2",
                      kernels=("weighted_hist",)),
}
# the cases whose port side runs a DE chain against the JAX chain (the
# 'expected' JAX chain is held against the port's NUTS and HMC instead)
DE_CHAIN_CASES = tuple(name for name, case in CASES.items()
                       if case["chain"] and case["sampling"] != "expected")
# The evidence cases: ``cli/shifting_gaussian.py``'s parallel tempering
# (20 temperatures x 100 walkers) on the JAX package's data, ln Z by
# thermodynamic integration from several seeds per package, and the cold
# chain.  ``steps``/``burnin``: the reference's cut of the CLI's 10,000 +
# 1,000 (both packages run the same).
PT_CASES = {
    "pt_shifting_gaussian": dict(model="analytic", temps=20, walkers=100,
                                 burnin=1000, steps=10_000, thin=10,
                                 seeds=5, kernels=()),
    "pt_shifting_gaussian_tof": dict(model="tof", temps=20, walkers=100,
                                     burnin=100, steps=300, thin=3,
                                     seeds=3,
                                     kernels=("counts_rates", "poisson",
                                              "tof_hist")),
}
# the evidence gate: |mean ln Z_port - mean ln Z_JAX| < LN_Z_SIGMAS x
# sqrt(var_J / n_J + var_P / n_P), the variances over each package's seeds
LN_Z_SIGMAS = 4.0
SIMULT_NAMES = ("beamE", "eLoss", "scale", "s")
ONEBD_NAMES = ("eLoss", "scale", "s")
def param_names(model: str, n_runs: int, n_dim: int = 0) -> list[str]:
    """The parameter names of a case: simultFit's and oneBD's by their
    runs, the simple family's and PT's as theta0.. (``n_dim``)."""
    if model not in ("simult", "onebd"):
        return [f"theta{d}" for d in range(n_dim)]
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


def chain_taus(chain) -> np.ndarray:
    """(D,) windowed autocorrelation times of a retained (S, W, D) chain:
    the larger of the walkers' (their mean autocorrelation) and that of
    the ensemble's median step by step.  A walker slot whose contents are
    swapped, as PT's cold rung is, reads ~1 step on its own while the
    ensemble moves slowly; so does a walker of an ensemble whose walkers
    move together."""
    chain = np.asarray(chain, np.float64)
    ensemble = np.median(chain, axis=1, keepdims=True)
    return np.maximum(integrated_autocorr_time(chain),
                      integrated_autocorr_time(ensemble))


def block_medians(chain) -> np.ndarray:
    """(B, D) medians of B contiguous time blocks of a retained (S, W, D)
    chain, each block's walkers pooled; the first S - B L steps are
    dropped.  B = S // (``BLOCK_TAUS`` tau), tau the largest of
    :func:`chain_taus`, clipped to [``MIN_BLOCKS``, ``MAX_BLOCKS``]."""
    chain = np.asarray(chain, np.float64)
    s, w, d = chain.shape
    tau = float(chain_taus(chain).max())
    n_blocks = int(np.clip(s // (BLOCK_TAUS * tau), MIN_BLOCKS, MAX_BLOCKS))
    length = s // n_blocks
    kept = chain[s - n_blocks * length:].reshape(n_blocks, length * w, d)
    return np.median(kept, axis=1)


def ar1_batch_factor(n_blocks: int, length: int, tau: float) -> float:
    """sqrt(Var(mean) / E[s^2 / B]) for B batch means of ``length`` steps
    of an AR(1) series of integrated autocorrelation time ``tau``: what
    the batch standard error is short by when its batches are not
    independent (>= 1; -> 1 as length / tau grows)."""
    rho = (tau - 1.0) / (tau + 1.0)
    if rho <= 0.0:
        return 1.0
    ell = float(length)
    tail = (1.0 - rho ** ell) / (1.0 - rho)
    var_b = (ell * (1 + rho) / (1 - rho)
             - 2 * rho * tail / (1 - rho)) / ell ** 2
    idx = np.arange(n_blocks)
    lag = np.abs(np.subtract.outer(idx, idx))
    cov = np.where(lag == 0, var_b,
                   rho ** np.maximum((lag - 1) * ell + 1, 0)
                   * (tail / ell) ** 2)
    var_mean = cov.sum() / n_blocks ** 2
    mean_s2 = (np.trace(cov) - cov.sum() / n_blocks) / (n_blocks - 1)
    return float(np.sqrt(max(var_mean * n_blocks / mean_s2, 1.0)))


def batch_median_se(chain) -> tuple[np.ndarray, int]:
    """Standard error of each parameter's median from batch medians, and
    its degrees of freedom B - 1: ``chain`` (S, W, D) retained.  The sd of
    the :func:`block_medians` over sqrt(B), times
    :func:`ar1_batch_factor` at the parameter's :func:`chain_taus`.
    Pooling a block's walkers carries the ensemble's between-walker
    correlation, which a per-walker autocorrelation misses; blocks of 4
    windowed taus and the AR(1) factor keep the SE from falling short on
    a chain of 8 tau (``tests/test_torch_posterior_parity_paths.py``: z's
    sd within [0.8, 1.25] at 8 and 50 tau, the tool's above 5)."""
    chain = np.asarray(chain, np.float64)
    s = chain.shape[0]
    meds = block_medians(chain)
    n_blocks = meds.shape[0]
    length = s // n_blocks
    factor = np.array([ar1_batch_factor(n_blocks, length, float(t))
                       for t in chain_taus(chain)])
    return meds.std(axis=0, ddof=1) / np.sqrt(n_blocks) * factor, n_blocks - 1


def chain_summary(chain, names) -> dict:
    """Per-parameter 16/50/84 percentiles, ``median_se`` (the tool's),
    ``batch_se`` and ``batch_dof`` (:func:`batch_median_se`), tau and ESS
    of a retained (S, W, D) chain: what a reference file keeps of a
    chain."""
    chain = np.asarray(chain, np.float64)
    s, w, _ = chain.shape
    batch_se, dof = batch_median_se(chain)
    out = {}
    for d, name in enumerate(names):
        q16, q50, q84 = np.percentile(chain[:, :, d].reshape(-1),
                                      [16, 50, 84])
        se, ess = median_se(chain[:, :, d])
        out[name] = {"q16": float(q16), "q50": float(q50),
                     "q84": float(q84), "median_se": float(se),
                     "ess": float(ess), "tau": float(s * w / ess),
                     "batch_se": float(batch_se[d]), "batch_dof": int(dof)}
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


def z_between(diff: float, se_a: float, dof_a: int, se_b: float,
              dof_b: int) -> tuple[float, float, float]:
    """A difference of two medians in their batch standard errors, as a
    normal quantile: the t ratio diff / sqrt(se_a^2 + se_b^2) carried
    through Student's t at the Welch-Satterthwaite degrees of freedom to
    the standard normal, so that ``Z_SE_MAX`` keeps its normal tail
    probability whatever the number of blocks.  Returns (z, t, dof)."""
    var, dof = _welch(se_a, dof_a, se_b, dof_b)
    if var <= 0.0:
        t = 0.0 if diff == 0 else float(np.copysign(np.inf, diff))
        return t, t, dof
    t = diff / np.sqrt(var)
    z = float(np.copysign(stats.norm.isf(stats.t.sf(abs(t), dof)), t))
    return z, float(t), dof


def _welch(se_a, dof_a, se_b, dof_b) -> tuple[float, float]:
    """The variance of a difference of two estimates and its
    Welch-Satterthwaite degrees of freedom."""
    var = se_a ** 2 + se_b ** 2
    if var <= 0.0:
        return 0.0, float(dof_a + dof_b)
    return var, float(var ** 2 / (se_a ** 4 / dof_a + se_b ** 4 / dof_b))


def z_se_reach(se: float, dof: float, pooled: float) -> float:
    """The difference of two medians, in pooled posterior sigmas, at which
    z_se reaches ``Z_SE_MAX``: ``se`` the difference's standard error,
    ``dof`` its Welch degrees of freedom (:func:`z_between`).  With 4
    blocks a side (dof ~6) that is a t of ~9."""
    t_max = stats.t.isf(stats.norm.sf(Z_SE_MAX), dof)
    return float(t_max * se / pooled) if pooled > 0 else np.inf


def dz_between(ref_summary: dict, port: dict, names) -> dict:
    """:func:`dz_table` of two :func:`chain_summary` results.  z_se is
    :func:`z_between` on the batch standard errors; ``z_se_tool``, the
    difference in the tool's ``median_se``, is reported beside it."""
    rows = []
    for name in names:
        r, p = ref_summary[name], port[name]
        sig_r = 0.5 * (r["q84"] - r["q16"])
        sig_p = 0.5 * (p["q84"] - p["q16"])
        pooled = np.sqrt(0.5 * (sig_r ** 2 + sig_p ** 2))
        diff = p["q50"] - r["q50"]
        dz = diff / pooled if pooled > 0 else np.inf
        z_se, t, dof = z_between(diff, r["batch_se"], r["batch_dof"],
                                 p["batch_se"], p["batch_dof"])
        z_tool = diff / np.sqrt(r["median_se"] ** 2 + p["median_se"] ** 2)
        reach = z_se_reach(np.hypot(r["batch_se"], p["batch_se"]), dof,
                           pooled)
        rows.append({"param": name, "ref_median": r["q50"],
                     "ref_sigma": sig_r, "port_median": p["q50"],
                     "port_sigma": sig_p, "dz": float(dz),
                     "z_se": z_se, "t": t, "dof": dof,
                     "z_se_reach": reach,
                     "ref_se": r["batch_se"], "port_se": p["batch_se"],
                     "z_se_tool": float(z_tool), "ref_ess": r["ess"],
                     "port_ess": p["ess"]})
    worst_dz = max(abs(row["dz"]) for row in rows)
    worst_se = max(abs(row["z_se"]) for row in rows)
    ok = bool(worst_dz < DZ_MAX and worst_se < Z_SE_MAX)
    return {"rows": rows, "worst_dz": worst_dz, "worst_z_se": worst_se,
            "worst_z_se_tool": max(abs(row["z_se_tool"]) for row in rows),
            "reach": gate_reach(rows),
            "min_ref_ess": min(row["ref_ess"] for row in rows),
            "min_port_ess": min(row["port_ess"] for row in rows),
            "verdict": "PASS" if ok else "REVIEW",
            "gate": f"|dz| < {DZ_MAX} and |z_se| < {Z_SE_MAX} (batch-median"
                    " SE)"}


def gate_reach(rows) -> dict:
    """The shift of a median, in pooled posterior sigmas, that the chain
    gate is sure to catch on every parameter of a dz table's ``rows``:
    a difference of that size fails |dz| < ``DZ_MAX`` or z_se <
    ``Z_SE_MAX`` (:func:`z_se_reach`, from the rows' standard errors and
    degrees of freedom), whichever comes first; and the same for z_se
    alone.  Rows without ``z_se_reach`` (tables written before it) have
    it computed from their ``ref_se``, ``port_se``, ``dof`` and
    sigmas."""
    reach = []
    for row in rows:
        r = row.get("z_se_reach")
        if r is None:
            pooled = np.sqrt(0.5 * (row["ref_sigma"] ** 2
                                    + row["port_sigma"] ** 2))
            r = z_se_reach(np.hypot(row["ref_se"], row["port_se"]),
                           row["dof"], pooled)
        reach.append((row["param"], r))
    name, worst = max(reach, key=lambda x: x[1])
    return {"sigma": min(DZ_MAX, worst), "z_se_sigma": worst,
            "z_se_best_sigma": min(r for _, r in reach),
            "widest_param": name,
            "by": "z_se" if worst < DZ_MAX else "dz"}


def format_dz(table: dict, names=("JAX", "port")) -> str:
    """The dz table as text, its two sides named by ``names``."""
    a, b = names
    lines = [f"{'param':>6} {a + ' med':>11} {a + ' sig':>9} "
             f"{b + ' med':>11} {b + ' sig':>9} {'dz':>6} {'z_se':>6} "
             f"{'dof':>5} {'z tool':>6} {'ESS ' + a:>10} {'ESS ' + b:>10}"]
    for r in table["rows"]:
        lines.append(f"{r['param']:>6} {r['ref_median']:11.5g} "
                     f"{r['ref_sigma']:9.3g} {r['port_median']:11.5g} "
                     f"{r['port_sigma']:9.3g} {r['dz']:6.3f} "
                     f"{r['z_se']:6.2f} {r['dof']:5.1f} "
                     f"{r['z_se_tool']:6.2f} {r['ref_ess']:10.0f} "
                     f"{r['port_ess']:10.0f}")
    reach = gate_reach(table["rows"])
    lines.append(f"worst |dz| {table['worst_dz']:.3f}, worst |z_se| "
                 f"{table['worst_z_se']:.2f} (the tool's SE: "
                 f"{table['worst_z_se_tool']:.2f}) -> {table['verdict']} "
                 f"({table['gate']}); catches a shift of "
                 f"{reach['sigma']:.3f} sigma on every parameter (by "
                 f"{reach['by']}; z_se alone {reach['z_se_best_sigma']:.3f}"
                 f"-{reach['z_se_sigma']:.3f})")
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


def finite_stats(lp):
    """Per row of (n, R) log-probs: the mean and standard deviation of its
    finite values, and how many there are (the mean is -inf and the sd
    NaN where none is, the sd NaN where one is)."""
    lp = np.asarray(lp, np.float64)
    fin = np.isfinite(lp)
    k = fin.sum(1)
    vals = np.where(fin, lp, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(k > 0, vals.sum(1) / k, -np.inf)
        dev = np.where(fin, lp - mean[:, None], 0.0)
        sd = np.where(k > 1, np.sqrt((dev ** 2).sum(1) / (k - 1)), np.nan)
    return mean, sd, k


def density_parity(ref_mean, ref_sd, port_mean, port_sd, repeats, thetas,
                   names, *, ref_n=None, port_n=None) -> dict:
    """The same-theta density check of a stochastic estimator.

    ``ref_mean``/``ref_sd`` (JAX) and ``port_mean``/``port_sd`` are the
    per-theta means and standard deviations of the log-prob over the
    finite ones of ``repeats`` evaluations each, ``ref_n``/``port_n``
    their numbers (default all ``repeats``).  With Delta_i the difference
    of the means and v_i = s_p,i^2 / n_p,i + s_J,i^2 / n_J,i its
    Monte-Carlo variance, over the m thetas with two finite values or
    more on both sides:

    * spread: the centred standard deviation of Delta; noise: sqrt(mean
      v_i), the spread Monte-Carlo noise alone gives; the JAX tool's gate
      spread < max(5 noise, 1 nat);
    * chi2/dof = sum_i (Delta_i - mean Delta)^2 / v_i / (m - 1), gated at
      ``chi2_dof_max(m)``: a systematic theta-dependent offset far below
      the nat floor still fails it.

    PASS when every theta is compared, or has no finite value on either
    side, and both gates hold: a theta finite on one side only fails it.
    How often each side is -inf is :func:`neg_inf_shares`' to judge.
    """
    ref_mean, ref_sd, port_mean, port_sd, thetas = (
        np.asarray(a, np.float64)
        for a in (ref_mean, ref_sd, port_mean, port_sd, thetas))
    n = ref_mean.shape[0]
    ref_n = np.full(n, repeats) if ref_n is None else np.asarray(ref_n)
    port_n = np.full(n, repeats) if port_n is None else np.asarray(port_n)
    finite = (np.isfinite(ref_mean) & np.isfinite(port_mean)
              & np.isfinite(ref_sd) & np.isfinite(port_sd)
              & (ref_n > 1) & (port_n > 1))
    neither = (ref_n == 0) & (port_n == 0)
    delta = (port_mean - ref_mean)[finite]
    var = (port_sd ** 2 / np.maximum(port_n, 1)
           + ref_sd ** 2 / np.maximum(ref_n, 1))[finite]
    m = delta.size
    spread = float(np.std(delta, ddof=1)) if m > 1 else np.inf
    noise = float(np.sqrt(np.mean(var))) if m else np.inf
    chi2 = (float(np.sum((delta - delta.mean()) ** 2
                         / np.maximum(var, 1e-300)) / (m - 1))
            if m > 1 else np.inf)
    chi2_max = chi2_dof_max(m) if m > 1 else np.inf
    spread_ok = spread < max(NOISE_FACTOR * noise, NATS_FLOOR)
    chi2_ok = chi2 <= chi2_max
    ok = bool(np.all(finite | neither) and m > 1 and spread_ok and chi2_ok)
    return {
        "n_thetas": n, "n_finite": int(m), "n_neither": int(neither.sum()),
        "repeats": int(repeats),
        "mean_offset_nats": float(delta.mean()) if m else np.nan,
        "spread_nats": spread, "noise_nats": noise,
        "spread_gate_nats": max(NOISE_FACTOR * noise, NATS_FLOOR),
        "chi2_dof": chi2, "chi2_dof_max": chi2_max,
        "ref_sd_median": float(np.nanmedian(ref_sd)),
        "port_sd_median": float(np.nanmedian(port_sd)),
        "correlations": _correlations(thetas[finite], delta, names),
        "spread_verdict": "PASS" if spread_ok else "REVIEW",
        "chi2_verdict": "PASS" if chi2_ok else "REVIEW",
        "verdict": "PASS" if ok else "REVIEW"}


def neg_inf_shares(ref_n, port_n, repeats: int) -> dict:
    """How often each package's log-prob is -inf at the same thetas:
    ``ref_n``/``port_n`` the finite evaluations of ``repeats`` per theta.
    Two-proportion tests of the -inf counts: pooled over the thetas (z),
    and per theta (the sum of the squared z_i over the thetas where
    either side has a -inf, as a chi-square with that many degrees of
    freedom, carried to a normal quantile).  PASS when both are below
    ``Z_SE_MAX``."""
    k_r = repeats - np.asarray(ref_n, np.float64)
    k_p = repeats - np.asarray(port_n, np.float64)
    n = k_r.size

    def z_two(a, b, trials):
        pooled = (a + b) / (2 * trials)
        var = pooled * (1 - pooled) * 2 / trials
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(var > 0, (b - a) / trials / np.sqrt(var), 0.0)

    z_all = float(z_two(k_r.sum(), k_p.sum(), n * repeats))
    some = (k_r + k_p) > 0
    z_i = z_two(k_r, k_p, repeats)[some]
    dof = int(some.sum())
    z_theta = (float(stats.norm.isf(stats.chi2.sf(float(np.sum(z_i ** 2)),
                                                  dof))) if dof else 0.0)
    ok = abs(z_all) < Z_SE_MAX and z_theta < Z_SE_MAX
    return {"ref_share": float(k_r.sum() / (n * repeats)),
            "port_share": float(k_p.sum() / (n * repeats)),
            "ref_neg_inf": k_r.astype(int).tolist(),
            "port_neg_inf": k_p.astype(int).tolist(),
            "z_pooled": z_all, "z_per_theta": z_theta,
            "thetas_with_neg_inf": dof,
            "verdict": "PASS" if ok else "REVIEW",
            "gate": f"|z| < {Z_SE_MAX} pooled and per theta"}


def evidence_parity(ref_ln_z, port_ln_z, *, port_var=None) -> dict:
    """ln Z from several seeds per package: PASS when |mean_port -
    mean_JAX| < ``LN_Z_SIGMAS`` sqrt(var_J / n_J + var_P / n_P), the
    variances over each package's seeds (``port_var``: the port's
    seed-to-seed variance where it ran fewer than two seeds, e.g. the
    JAX package's)."""
    ref = np.asarray(ref_ln_z, np.float64)
    port = np.asarray(port_ln_z, np.float64)
    var_r = float(ref.var(ddof=1))
    var_p = float(port.var(ddof=1)) if port.size > 1 else float(port_var)
    noise = float(np.sqrt(var_r / ref.size + var_p / port.size))
    diff = float(port.mean() - ref.mean())
    ok = abs(diff) < LN_Z_SIGMAS * noise
    return {"ref_ln_z": ref.tolist(), "port_ln_z": port.tolist(),
            "ref_mean": float(ref.mean()), "port_mean": float(port.mean()),
            "ref_sd": float(np.sqrt(var_r)), "port_sd": float(np.sqrt(var_p)),
            "diff": diff, "noise": noise, "z": diff / noise,
            "verdict": "PASS" if ok else "REVIEW",
            "gate": f"|diff| < {LN_Z_SIGMAS} noise"}


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
    thetas: np.ndarray    # (n, D) float32; None on an evidence case
    arrays: dict          # lp_mean, lp_sd, lp_n_finite | lp, grad | ln_z

    @property
    def names(self) -> list[str]:
        return self.meta.get("names") or param_names(self.meta["model"],
                                                     self.meta["n_runs"])


def load_reference(path) -> Reference:
    """Read ``<case>.npz`` and its ``<case>.json`` beside it."""
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as z:
        observed = tuple(z[f"observed_{r}"] for r in range(meta["n_runs"]))
        arrays = {k: z[k] for k in z.files
                  if not k.startswith("observed_") and k != "thetas"}
        thetas = z["thetas"] if "thetas" in z.files else None
    return Reference(meta, observed, thetas, arrays)


def build_problem(meta: dict, device):
    """The port's problem for a case's spec fields; its spec must agree
    with the JAX spec's fields that the reference file records."""
    from ..models import onebd, simult

    if meta["model"] == "simple":
        from ..cli.simple_tof import build_problem as simple_problem

        spec, _, problem = simple_problem(meta["simple_model"],
                                          meta["n_draws"], device)
        _check_spec(meta, spec)
        return problem
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
    _check_spec(meta, spec)
    return cls(spec, n_runs=meta["n_runs"], likelihood=meta["likelihood"],
               device=device)


def _check_spec(meta: dict, spec) -> None:
    for field, want in meta["spec_fields"].items():
        got = getattr(spec, field)
        if got != want:
            raise ValueError(f"{meta['case']}: the port's spec has {field} = "
                             f"{got!r}, the reference {want!r}")


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
    lp = repeat_log_probs(problem, _log_prob_observed(ref), thetas, repeats,
                          seed,
                          chunk=256 if ref.meta["sampling"] == "mc" else 512)
    mean, sd, n_fin = finite_stats(lp)
    ref_n = ref.arrays.get("lp_n_finite", np.full(len(thetas), repeats))
    out = density_parity(ref.arrays["lp_mean"], ref.arrays["lp_sd"], mean,
                         sd, repeats, thetas, names, ref_n=ref_n,
                         port_n=n_fin)
    shares = neg_inf_shares(ref_n, n_fin, repeats)
    out["neg_inf"] = shares
    out["density_verdict"] = out["verdict"]
    out["verdict"] = ("PASS" if out["verdict"] == shares["verdict"] == "PASS"
                      else "REVIEW")
    out["port_lp_mean"] = mean.tolist()
    out["port_lp_sd"] = sd.tolist()
    return out


def _log_prob_observed(ref: Reference):
    """What the case's ``make_log_prob_fn`` takes: the runs, or the
    simple family's one histogram."""
    return ref.observed[0] if ref.meta["model"] == "simple" else ref.observed


def run_port_chain(ref: Reference, problem, *, seed: int = 0):
    """The port's DE chain at the reference chain's walkers and steps, from
    the port's ``initial_walkers_from_observed``: (retained (S, W, D)
    float64 numpy, mean acceptance)."""
    from ..sampler import init_state, run_mcmc

    ch = ref.meta["chain"]
    dev = problem.device
    logp = problem.make_log_prob_fn(_log_prob_observed(ref))
    gen = torch.Generator(dev).manual_seed(seed)
    if ref.meta["model"] == "simple":
        # the simple CLI's start: truth x 1.02 + 0.01 N(0, 1)
        center = torch.as_tensor(ref.meta["init_center"],
                                 dtype=torch.float32, device=dev)
        p0 = center + ref.meta["init_scale"] * torch.randn(
            (ch["walkers"], center.numel()), generator=gen, device=dev)
    else:
        p0 = problem.initial_walkers_from_observed(gen, ch["walkers"],
                                                   ref.observed)
    state = init_state(p0, logp, generator=gen,
                       eval_generator=torch.Generator().manual_seed(seed + 1))
    state = run_mcmc(state, ch["burnin"], logp, move="de").state
    chain = run_mcmc(state, ch["main"], logp, move="de")
    acc = float(chain.acceptance_fraction.float().mean())
    return chain.positions.double().cpu().numpy(), acc


# ---- the evidence cases (parallel tempering) --------------------------------

def run_port_pt(meta: dict, observed, device, seed: int):
    """One seed of the port's PT at the reference's temperatures, walkers
    and (cut) steps, on the JAX package's observed arrays: the posterior
    and start of ``cli/shifting_gaussian.py`` (``analytic_pt_setup``,
    ``tof_pt_setup``, whose spec must agree with the fields the reference
    records) through its ``run_tempered`` with its streams: (ln Z,
    d ln Z, cold chain (S, W, D) float64 numpy, swap acceptance,
    seconds)."""
    from ..cli import shifting_gaussian as cli_sg

    shape = (seed, meta["temps"], meta["walkers"], device)
    if meta["model"] == "analytic":
        data = torch.as_tensor(observed[0], dtype=torch.float32,
                               device=device)
        loglike, logprior, p0 = cli_sg.analytic_pt_setup(data, *shape)
    else:
        problem, _, loglike, logprior, p0 = cli_sg.tof_pt_setup(
            *shape, observed=observed)
        _check_spec(meta, problem.spec)
    _, chain, seconds = cli_sg.run_tempered(
        p0, meta["burnin"], meta["steps"], meta["thin"], loglike, logprior,
        seed=seed, move="stretch")
    ln_z, d_ln_z = chain.thermodynamic_integration_log_evidence()
    swaps = (chain.n_swaps_accepted.numpy() / meta["steps"]
             / meta["walkers"])
    return (float(ln_z), float(d_ln_z),
            chain.cold_chain.double().numpy(), swaps.tolist(), seconds)
