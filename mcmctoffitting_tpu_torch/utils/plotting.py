"""Diagnostic plotting: chain traces, lnprob scatters, corner plots.

A copy of ``mcmctoffitting_tpu/utils/plotting.py`` (numpy + matplotlib;
the port imports nothing of the JAX package).  It rebuilds the
reference's visualization layer (``utilities/plotChains_oneBD.py:101-203``,
``tests/plotChainFromFile.py:88-148``, corner plots
``utilities/ppcTools.py:425-436``) on bare matplotlib.  The ``corner``
package is not a dependency: :func:`corner_plot` implements the
quantile-annotated corner grid directly.

All functions accept (S, W, D) chains as produced by the native sampler or
read back via ``chain_io.read_chain_text``, and are import-guarded so the
core library never requires matplotlib.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def trace_plot(chain, param_names: Optional[Sequence[str]] = None,
               filename: Optional[str] = None, *, alpha: float = 0.2,
               max_params: int = 12):
    """Per-parameter walker trace plot (burn-in diagnostics;
    ``tests/simultFit.py:746-763``)."""
    plt = _plt()
    chain = np.asarray(chain)  # (S, W, D)
    n_params = min(chain.shape[-1], max_params)
    fig, axes = plt.subplots(n_params, 1, figsize=(8, 2.2 * n_params),
                             sharex=True, squeeze=False)
    for d in range(n_params):
        ax = axes[d, 0]
        ax.plot(chain[:, :, d], "-", color="k", alpha=alpha, lw=0.5)
        ax.set_ylabel(param_names[d] if param_names else f"$\\theta_{{{d}}}$")
    axes[-1, 0].set_xlabel("Step")
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def lnprob_scatter(chain, log_probs, param_index: int = 0,
                   param_name: Optional[str] = None,
                   filename: Optional[str] = None):
    """ln-prob vs parameter scatter (``utilities/plotChains_oneBD.py:194-199``)."""
    plt = _plt()
    chain = np.asarray(chain)
    lp = np.asarray(log_probs)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.scatter(chain[:, :, param_index].ravel(), lp.ravel(), s=2, alpha=0.2,
               color="k")
    ax.set_xlabel(param_name or f"$\\theta_{{{param_index}}}$")
    ax.set_ylabel("ln prob")
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def param_hist(chain, param_index: int = 0, bins: int = 50,
               filename: Optional[str] = None):
    """Marginal histogram of one parameter (``tests/plotChainFromFile.py``)."""
    plt = _plt()
    vals = np.asarray(chain)[:, :, param_index].ravel()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(vals, bins=bins, color="0.3")
    ax.set_xlabel(f"$\\theta_{{{param_index}}}$")
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def corner_plot(samples, labels: Optional[Sequence[str]] = None,
                quantiles: Sequence[float] = (0.16, 0.5, 0.84),
                truths: Optional[Sequence[float]] = None,
                bins: int = 40, filename: Optional[str] = None):
    """Corner (pairwise marginal) plot with quantile titles.

    Native replacement for ``corner.corner(...)`` as used in
    ``utilities/ppcTools.py:425-436`` (flattened chain tail, 16/50/84%
    quantile titles).
    """
    plt = _plt()
    x = np.asarray(samples)
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    d = x.shape[1]
    fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d))
    if d == 1:
        axes = np.array([[axes]])
    for i in range(d):
        for j in range(d):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(x[:, i], bins=bins, color="0.3",
                        histtype="stepfilled")
                q = np.quantile(x[:, i], quantiles)
                for qv in q:
                    ax.axvline(qv, color="k", ls="--", lw=0.8)
                med, lo, hi = q[1], q[1] - q[0], q[2] - q[1]
                name = labels[i] if labels else f"$\\theta_{{{i}}}$"
                ax.set_title(f"{name} = {med:.3g}$^{{+{hi:.2g}}}"
                             f"_{{-{lo:.2g}}}$", fontsize=9)
                if truths is not None:
                    ax.axvline(truths[i], color="tab:blue", lw=1.2)
            else:
                ax.hist2d(x[:, j], x[:, i], bins=bins, cmap="Greys")
                if truths is not None:
                    ax.axvline(truths[j], color="tab:blue", lw=1.0)
                    ax.axhline(truths[i], color="tab:blue", lw=1.0)
            if i < d - 1:
                ax.set_xticklabels([])
            if j > 0:
                ax.set_yticklabels([])
            if i == d - 1 and labels:
                ax.set_xlabel(labels[j])
            if j == 0 and i > 0 and labels:
                ax.set_ylabel(labels[i])
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def model_overlay_plot(observed, model, filename: Optional[str] = None):
    """Observed vs model counts with residuals, the checkLikelihoodEval
    figure (``tests/simultFit.py:500-512``)."""
    plt = _plt()
    obs = np.asarray(observed)
    mod = np.asarray(model)
    idx = np.arange(len(obs))
    fig, (ax_overlay, ax_resid) = plt.subplots(2, figsize=(7, 6),
                                               sharex=True)
    ax_overlay.scatter(idx, obs, color="green", s=14, label="observed")
    ax_overlay.scatter(idx, mod, color="red", s=14, label="model")
    ax_overlay.set_ylabel("Counts")
    ax_overlay.legend()
    ax_resid.scatter(idx, obs - mod, s=14, color="k")
    ax_resid.axhline(0, color="0.5", lw=0.8)
    ax_resid.set_ylabel("Residual")
    ax_resid.set_xlabel("TOF bin")
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def initial_energy_plot(beam_e: float, e_loss: float, scale: float, s: float,
                        filename: Optional[str] = None, *,
                        n_samples: int = 100_000, e_range=(0.0, 2500.0)):
    """Visualize the beamE - lognorm initial-energy parameterization
    (``utilities/dumbPlotting.py:32-55``): the analytic pdf of
    E = beamE - lognorm(s, loc, scale) overlaid on a sampled histogram."""
    plt = _plt()
    from scipy.stats import lognorm as sp_lognorm
    rng = np.random.default_rng(0)
    samples = beam_e - sp_lognorm.rvs(s, e_loss, scale, size=n_samples,
                                      random_state=rng)
    grid = np.linspace(*e_range, 800)
    pdf = sp_lognorm.pdf(beam_e - grid, s, e_loss, scale)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.hist(samples, bins=200, range=e_range, density=True, color="0.7",
            label="samples")
    ax.plot(grid, pdf, color="tab:red", lw=1.5, label="analytic pdf")
    ax.set_xlabel("Initial deuteron energy (keV)")
    ax.set_ylabel("density")
    ax.legend()
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def unfolded_spectrum_plot(template_energies, samples,
                           run_names: Optional[Sequence[str]] = None,
                           filename: Optional[str] = None):
    """Template-fit posterior summary: the unfolded energy spectrum.

    Rebuilds the reference's final devShapeTemplates visualization
    (``tests/devShapeTemplates.py:584-631``): (1) the unfolded spectrum —
    per-slice energy coefficients vs template energy as a median curve
    with a 16-84% credible band plus errorbar points (the reference's
    mean +- std errorbar plot, ``:616-621``), and (2) per-run scale-factor
    posterior histograms with dashed/dotted 16/50/84 quantile lines
    (``:597-606``).

    Parameters
    ----------
    template_energies : (T,) slice energies (keV)
    samples : (N, n_scales + T) flat posterior samples — run scales first,
        then the template coefficients (the reference's layout)
    """
    plt = _plt()
    e = np.asarray(template_energies, dtype=np.float64)
    flat = np.asarray(samples, dtype=np.float64)
    n_scales = flat.shape[1] - e.size
    if n_scales < 1:
        raise ValueError(
            f"samples have {flat.shape[1]} columns for {e.size} template "
            "energies; expected >= 1 leading run-scale column")
    coeffs = flat[:, n_scales:]
    q = np.percentile(coeffs, [16, 50, 84], axis=0)       # (3, T)

    fig, axes = plt.subplots(
        1 + n_scales, 1, figsize=(8, 4 + 1.6 * n_scales),
        gridspec_kw={"height_ratios": [3] + [1] * n_scales})
    ax = axes[0]
    ax.fill_between(e, q[0], q[2], color="tab:orange", alpha=0.4,
                    label="16-84% credible band")
    ax.plot(e, q[1], color="tab:red", lw=1.2, label="median")
    ax.errorbar(e, coeffs.mean(axis=0), yerr=coeffs.std(axis=0),
                fmt="k.", ms=4, lw=0.8, label="mean $\\pm$ std")
    ax.set_xlabel("Energy (keV)")
    ax.set_ylabel("Energy coefficient")
    ax.set_title("Unfolded energy spectrum (template coefficients)")
    ax.legend()
    for r in range(n_scales):
        axr = axes[1 + r]
        vals = flat[:, r]
        axr.hist(vals, bins=30, color="0.7")
        q_lo, q_med, q_hi = np.percentile(vals, [16, 50, 84])
        axr.axvline(q_med, color="r", ls="dashed")
        axr.axvline(q_lo, color="r", ls="dotted")
        axr.axvline(q_hi, color="r", ls="dotted")
        axr.set_ylabel(run_names[r] if run_names
                       else f"Scale factor, run {r + 1}")
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig


def ppc_band_plot(observed, bands, bin_edges=None,
                  filename: Optional[str] = None):
    """Observed counts vs 16/50/84% PPC bands (``tests/testPPC.py:110-139``)."""
    plt = _plt()
    obs = np.asarray(observed)
    bands = np.asarray(bands)  # (3, n_bins)
    xs = np.arange(len(obs)) if bin_edges is None else np.asarray(bin_edges)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.fill_between(xs, bands[0], bands[2], color="tab:orange", alpha=0.4,
                    label="68% PPC band")
    ax.plot(xs, bands[1], color="tab:red", lw=1.0, label="PPC median")
    ax.step(xs, obs, where="mid", color="k", lw=1.0, label="observed")
    ax.set_xlabel("TOF bin")
    ax.set_ylabel("Counts")
    ax.legend()
    fig.tight_layout()
    if filename:
        fig.savefig(filename, dpi=200)
        plt.close(fig)
    return fig
