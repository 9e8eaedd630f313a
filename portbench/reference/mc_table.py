"""The plain reference of the simultFit CLI's default estimator: mc on
the stopping table through the e0grid operator (the traffic's
``sampling`` 'mc', ``transport`` 'table', ``xs_mode`` 'e0grid'), in plain
PyTorch and NumPy.

Stage by stage:

* the campaign: ``tables.campaign`` with F = 256 fine e0 cells where the
  mix gives no ``fine_grid`` (the preset's mc default), so that it
  carries the e0-space operator A (4 F, M Be) that ``tables.py`` builds
  from the stopping table;
* the beam draw (``ode.py``): two 32-bit words of the host generator
  seed a generator on the device, which draws (W, R, N) uniforms in
  [tiny, 1) at once; the truncated lognormal's inverse CDF maps them to
  initial energies;
* the fine-cell moments: per (walker, run) row, the sums of (1, t, t^2,
  t^3) over the draws of each fine cell, t = (e0 - t_ref) / t_scale, with
  cell = clip(floor((e0 - e0_lo) F / (e0_hi - e0_lo)), 0, F - 1) and
  draws outside the closed range [e0_lo, e0_hi] (NaN included) adding
  nothing; the channels are float32, summed in float64 in blocks of rows
  and rounded to float32 once;
* the contraction with the dense A (``forward.py``'s ``matmul``, blocks
  of a fixed row count, TF32 off), and the sample mean of e0 for the
  lattice;
* the shared stages of ``forward.py``: the density grid scaled to the
  draws and rounded, the TOF lattice, its histogram into each run's
  window, density, the ExGaussian 'same' convolution (TF32 off), the run
  scales, the corrected Poisson likelihood and the box prior.

Departures from gcrich/mcmcTOFfitting ``tests/simultFit.py``
(``generateModelData``, ``:223-300``), each the program's own:

* the ODE of every sample is replaced by the stopping table's e0-space
  preimage operator: the energy loss E(e0, x) is tabulated once (float64
  RK4 of the full Bethe formula, 64 substeps, a cubic spline along e0),
  each (x, eD) bin's preimage in e0 is inverted from it, and the cross
  section along the preimage is a cubic in t on each of the F fine cells,
  integrated against the draws' moments in the cell (boundary cells by a
  linear density);
* float32 throughout, where the reference computes in float64;
* the lognormal drawn truncated to e0 > 0 by its inverse CDF in place of
  the redraw loop (the same law);
* 200k draws an evaluation, more than the reference's fitting script
  drew.

``tf32=True`` runs the matrix products in TF32: one of the benchmark's
controls (``control_mc_table.py``), which the check has to fail.
"""
from __future__ import annotations

import torch

from . import ode, tables
from .forward import Reference as SharedStages
from .poisson import seed_words

N_FINE = 256                           # the preset's F for mc
ROWS = {"cuda": 64, "cpu": 8}          # (walker, run) rows summed at once


def campaign(config: dict, traffic: dict) -> tables.Campaign:
    """The campaign of a simultFit configuration under the mc mix on the
    stopping table (``transport`` 'table', ``xs_mode`` 'e0grid')."""
    if config["model"] != "simult":
        raise ValueError("the mc-table reference holds the simultFit "
                         "campaign")
    if (traffic.get("transport"), traffic.get("xs_mode")) != ("table",
                                                              "e0grid"):
        raise ValueError("the mc-table reference holds transport 'table' "
                         "with xs_mode 'e0grid'")
    if traffic.get("fine_grid") is None:
        traffic = dict(traffic, fine_grid=N_FINE)
    return tables.campaign(config, traffic)


def moment_sums(e0: torch.Tensor, op: tables.E0Operator) -> torch.Tensor:
    """(rows, N) initial energies -> (rows, 4, F) float64 sums over each
    fine cell of (1, t, t^2, t^3), the channels in float32."""
    f = op.n_fine
    rows = e0.shape[0]
    inside = (e0 >= op.e0_lo) & (e0 <= op.e0_hi)
    cell = torch.floor((e0 - op.e0_lo) * (f / (op.e0_hi - op.e0_lo)))
    cell = torch.clamp(torch.where(inside, cell, 0.0), 0, f - 1).long()
    t = (e0 - op.t_ref) * (1.0 / op.t_scale)
    t2 = t * t
    chans = torch.stack([torch.ones_like(t), t, t2, t2 * t], dim=1)
    chans = torch.where(inside[:, None], chans, 0.0).double()
    cells = cell[:, None] + f * torch.arange(4, device=e0.device)[:, None]
    out = torch.zeros((rows, 4 * f), dtype=torch.float64, device=e0.device)
    out.scatter_add_(1, cells.reshape(rows, -1), chans.reshape(rows, -1))
    return out.reshape(rows, 4, f)


class Reference(SharedStages):
    """The mc-table log-prob of a :class:`tables.Campaign` on ``device``:
    this module's grid stage, then the shared stages of ``forward.py``."""

    def fine_moments(self, e0: torch.Tensor) -> torch.Tensor:
        """(rows, N) initial energies -> (rows, 4, F) fine-cell moments,
        summed in float64 in blocks of rows and rounded once."""
        block = ROWS.get(e0.device.type, ROWS["cpu"])
        return torch.cat([moment_sums(e0[i:i + block], self.c.operator)
                          .float() for i in range(0, e0.shape[0], block)])

    def grid_and_mean(self, params, generator):
        """(W, 4) beam parameters -> ((W, R, M, Be) cross-section-weighted
        grids, (W, R) e0 sample means): N draws a walker and run."""
        op = self.c.operator
        shape = (params.shape[0], self.c.n_runs, self.c.n_samples)
        u = ode.beam_uniforms(shape, seed_words(generator), self.device)
        e0 = ode.beam_energies(u, params)
        del u
        moments = self.fine_moments(e0.reshape(-1, shape[-1]))
        grids = self.matmul(moments.reshape(-1, 4 * op.n_fine), self.a)
        return (grids.reshape(shape[:2] + (op.n_x, op.n_ed)),
                torch.mean(e0, dim=-1))
