"""The plain reference of the mc estimator on the ODE path (the traffic's
``sampling`` 'mc', ``transport`` 'rk4', ``xs_mode`` 'taylor'): the
simultFit campaign's tables and the log-prob, in plain PyTorch and NumPy.

Stage by stage (``ode.py`` holds the mc stages):

* the beam draw: two 32-bit words of the host generator seed a generator
  on the device, which draws (W, R, N) uniforms in [tiny, 1) at once;
  the truncated lognormal's inverse CDF maps them to initial energies;
* the transport of every sample through the 10 x centres of the gas
  cell, one RK4 step an interval, on the closed-form dE/dx with the 20
  keV floor, in blocks of rows of the (W R, N) energies;
* the moment histograms of (1, d, d^2, d^3) per eD bin and depth, summed
  in float64 and rounded to float32 once;
* the Taylor contraction with the cross section's coefficients at the
  eD bin centres, and the sample mean of e0 for the lattice;
* the shared stages of ``forward.py``: the density grid scaled to the
  draws and rounded, the TOF lattice, its histogram into each run's
  window, density, the ExGaussian 'same' convolution (TF32 off), the run
  scales, the corrected Poisson likelihood and the box prior.

Departures from gcrich/mcmcTOFfitting ``tests/simultFit.py``
(``generateModelData``, ``:223-300``), each the program's own:

* RK4 with one fixed step per x interval in place of ``odeint``'s
  adaptive dopri5, and the Bethe formula reduced to the closed form
  dE/dx = -(a/E)(p + q ln E) (the same mathematics, rounded apart);
* float32 throughout, where the reference computes in float64;
* the cross section at each transported energy by its Taylor expansion
  to third order around the eD bin centre, in place of the spline at
  that energy;
* the lognormal drawn truncated to e0 > 0 by its inverse CDF in place of
  the redraw loop (the same law).

A campaign whose ``transport`` is 'table' reads the stopping table in
place of the ODE: the benchmark's control (``control_mc.py``), which the
check has to fail; ``tf32=True`` is its other control.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ode, tables
from .forward import Reference as SharedStages
from .poisson import seed_words
from .tables import (M_NEUTRON, Binning, Campaign, dd_neutron_energy_np,
                     exgaussian_kernel, tof_np, zero_degree_segments)

RHO = 8.565e-5                         # g/cm^3, the simultFit gas cell
ROWS = {"cuda": 64, "cpu": 4}          # (walker, run) rows transported at once


@dataclasses.dataclass
class McCampaign(Campaign):
    """A simultFit campaign on the mc estimator: the shared tables of
    :class:`tables.Campaign` (its ``operator`` unused, None), the RK4
    constants, the Taylor coefficients (4, Be) and the ODE's stand-in,
    the stopping table, read when ``transport`` is 'table'."""

    rk4: ode.Rk4 = None
    taylor: np.ndarray = None
    table: tables.StoppingTable = None
    transport: str = "rk4"


def campaign(config: dict, traffic: dict) -> McCampaign:
    """The campaign of a simultFit configuration under an mc mix on the
    ODE path (``transport`` 'rk4', ``xs_mode`` 'taylor')."""
    if config["model"] != "simult":
        raise ValueError("the mc reference holds the simultFit campaign")
    if (traffic.get("transport"), traffic.get("xs_mode")) != ("rk4",
                                                              "taylor"):
        raise ValueError("the mc reference holds transport 'rk4' with "
                         "xs_mode 'taylor'")
    n_runs = int(config["n_runs"])
    ed, x = Binning(200.0, 1200.0, 50), Binning(0.0, tables.CELL_LENGTH, 10)
    names = tables.SIMULT_RUNS[:n_runs]
    zt, zw = zero_degree_segments(dd_neutron_energy_np(ed.centers))
    return McCampaign(
        model="simult", n_runs=n_runs, n_samples=int(config["n_samples"]),
        truncated=True, ed=ed, x=x, operator=None, a_bfloat16=False,
        standoffs=tuple(tables._SIMULT_STANDOFF[n] for n in names),
        windows=tuple(tables._SIMULT_WINDOW[n] for n in names),
        timing_kernel=exgaussian_kernel(), zero_degree="segments", zt=zt,
        zw=zw, attenuation=None, background=False,
        param_lo=np.concatenate([[1825.0, 600.0, 40.0, 0.1],
                                 np.full(n_runs, 0.0)]),
        param_hi=np.concatenate([[1925.0, 1000.0, 300.0, 1.2],
                                 np.full(n_runs, 1.0e6)]),
        rk4=ode.rk4_constants(RHO, x.centers),
        taylor=ode.taylor_coefficients(ed),
        table=tables.StoppingTable.build(RHO, ode.TABLE_BINNING, x.centers,
                                         energy_floor=ode.ENERGY_FLOOR))


class Reference(SharedStages):
    """The mc log-prob of a :class:`McCampaign` on ``device``: this
    module's grid stage, then the shared stages of ``forward.py``."""

    def __init__(self, camp: McCampaign, observed, device, *, tf32=False):
        self.c = camp
        self.device = torch.device(device)
        self.tf32 = tf32

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32),
                                   device=self.device)

        self.taylor = f32(camp.taylor)
        self.lookup = (ode.TableLookup(camp.table, self.device)
                       if camp.transport == "table" else None)
        x = camp.x.centers.astype(np.float32)
        self.x = f32(x)
        self.ed = f32(camp.ed.centers)
        en = np.asarray(dd_neutron_energy_np(camp.ed.centers), np.float32)
        n_dist = (np.float32(tables.CELL_LENGTH) - x[None, :, None]
                  + np.asarray(camp.standoffs, np.float32)[:, None, None])
        self.tof_n = f32(tof_np(M_NEUTRON, en[None, None, :], n_dist))
        self.zt, self.zw = f32(camp.zt), f32(camp.zw)
        w = camp.windows
        self.n_pad = max(v.n_bins for v in w)
        self.win_lo = f32([v.lo for v in w])
        self.win_hi = f32([v.hi for v in w])
        self.win_scale = f32([np.float32(v.n_bins / (v.hi - v.lo))
                              for v in w])
        self.win_nb1 = torch.as_tensor([v.n_bins - 1 for v in w],
                                       device=self.device)
        self.bin_widths = f32([[(v.hi - v.lo) / v.n_bins] for v in w])
        self.pad_mask = torch.as_tensor(
            np.arange(self.n_pad)[None, :]
            < np.asarray([v.n_bins for v in w])[:, None], device=self.device)
        self.timing = f32(tables.same_conv_matrix(camp.timing_kernel,
                                                  self.n_pad))
        self.expo, self.atten = None, None
        self.area = camp.ed.width * camp.x.width
        self.lo, self.hi = f32(camp.param_lo), f32(camp.param_hi)
        counts = np.zeros((camp.n_runs, self.n_pad), np.float32)
        for r, obs in enumerate(observed or ()):
            counts[r, :len(obs)] = obs
        self.observed = torch.as_tensor(counts, device=self.device)

    def interval(self, e, e0, m):
        """Energies at depth ``m``: one RK4 interval on from ``e``, or
        with the stopping table read at ``e0``."""
        if self.lookup is not None:
            return self.lookup.at(e0, m)
        return ode.rk4_interval(self.c.rk4, e, m)

    def moments(self, e0: torch.Tensor) -> torch.Tensor:
        """(rows, N) initial energies -> (rows, M, 4, Be) moment
        histograms, in blocks of rows."""
        block = ROWS.get(e0.device.type, ROWS["cpu"])
        return torch.cat([
            ode.transport_moments(e0[i:i + block], self.c.ed, self.c.x.n,
                                  self.interval)
            for i in range(0, e0.shape[0], block)])

    def grid_and_mean(self, params, generator):
        """(W, 4) beam parameters -> ((W, R, M, Be) cross-section-weighted
        grids, (W, R) e0 sample means): N draws a walker and run."""
        shape = (params.shape[0], self.c.n_runs, self.c.n_samples)
        u = ode.beam_uniforms(shape, seed_words(generator), self.device)
        e0 = ode.beam_energies(u, params)
        del u
        moments = self.moments(e0.reshape(-1, shape[-1]))
        grids = torch.sum(moments * self.taylor, dim=-2)
        return (grids.reshape(shape[:2] + grids.shape[-2:]),
                torch.mean(e0, dim=-1))
