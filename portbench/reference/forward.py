"""The plain reference of the counts log-probability, in PyTorch.

The counts estimator of the simultFit and csi_oneBD presets, stage by
stage, with no kernel of the program: the Poisson rates of the F fine e0
cells (a chain of ndtr differences), their Poisson draws (the frozen
plain K1, ``reference/poisson.py``), the fine-cell moments, the A
contraction, for oneBD the cell attenuation, the density grid scaled to
the draws and rounded, the TOF lattice, its histogram into each run's
window (float64 sums of every sample, rounded to float32 once), density,
for oneBD the causal 'expo' kernel and the Poisson background, the timing
convolution, the run scales, the corrected Poisson likelihood and the box
prior.  The arithmetic is the program's as of this benchmark's first
version, in float32, with the matrix products in blocks of 512 rows (64
on the CPU) and TF32 off, so that on the same proposals and seed words
it follows the program to the last bits, save for rounding ties.

``tf32=True`` runs the matrix products in TF32: the benchmark's control,
which its check has to fail.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import poisson as plain_k1
from .poisson import seed_words
from .tables import (M_DEUTERON, M_NEUTRON, SPEED_OF_LIGHT, Campaign,
                     causal_conv_matrix, dd_neutron_energy_np, expo_kernel,
                     same_conv_matrix, tof_np)

ROWS = {"cuda": 512, "cpu": 64}     # rows per matrix product, by device
_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def ndtr(x):
    w = x * _HALF_SQRT_2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def relu_split(x):
    return 0.5 * (x + torch.abs(x))


class Reference:
    """The counts log-prob of a :class:`tables.Campaign` on ``device``."""

    def __init__(self, camp: Campaign, observed, device, *, tf32=False):
        self.c = camp
        self.device = torch.device(device)
        self.tf32 = tf32
        op = camp.operator

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32),
                                   device=self.device)

        self.e0_lo, self.e0_hi = float(op.e0_lo), float(op.e0_hi)
        self.t_ref, self.t_scale = float(op.t_ref), float(op.t_scale)
        f = op.n_fine
        edges = torch.as_tensor(
            self.e0_lo + (self.e0_hi - self.e0_lo) / f * np.arange(f + 1),
            dtype=torch.float32, device=self.device)
        self.edges = edges
        a = torch.as_tensor(op.a_matrix, device=self.device)
        if camp.a_bfloat16:
            a = a.to(torch.bfloat16).to(torch.float32)
        self.a = a
        self.js = torch.arange(4, dtype=torch.float32, device=self.device)
        x = camp.x.centers.astype(np.float32)
        self.x = f32(x)
        self.ed = f32(camp.ed.centers)
        en = np.asarray(dd_neutron_energy_np(camp.ed.centers), np.float32)
        n_dist = (np.float32(2.86) - x[None, :, None]
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
        self.timing = f32(same_conv_matrix(camp.timing_kernel, self.n_pad))
        self.expo = (f32(causal_conv_matrix(expo_kernel(), self.n_pad))
                     if camp.zero_degree == "expo" else None)
        self.atten = (None if camp.attenuation is None
                      else f32(camp.attenuation))
        self.area = camp.ed.width * camp.x.width
        self.lo, self.hi = f32(camp.param_lo), f32(camp.param_hi)
        counts = np.zeros((camp.n_runs, self.n_pad), np.float32)
        for r, obs in enumerate(observed or ()):
            counts[r, :len(obs)] = obs
        self.observed = torch.as_tensor(counts, device=self.device)

    # --- stages ---------------------------------------------------------------

    def matmul(self, rows, mat):
        """rows (n, K) @ mat, in products of a fixed row count."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            block = ROWS.get(rows.device.type, ROWS["cpu"])
            n = rows.shape[0]
            if n % block:
                rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % block))
            return torch.cat([rows[i:i + block] @ mat
                              for i in range(0, rows.shape[0], block)])[:n]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _law(self, beam_e, e_loss, scale, s):
        valid = (scale > 0.0) & (s > 0.0)
        safe_scale = torch.where(scale > 0.0, scale, 1.0)
        safe_s = torch.where(s > 0.0, s, 1.0)

        def w_of(e0):
            return (beam_e - e0 - e_loss) / safe_scale

        def partial(j, lo, hi):
            lo_c = torch.clamp_min(lo, 1e-30)
            top = 1.0 if hi is None else ndtr(
                torch.log(torch.clamp_min(hi, 1e-30)) / safe_s - j * safe_s)
            amt = top - ndtr(torch.log(lo_c) / safe_s - j * safe_s)
            return torch.exp(0.5 * j * j * safe_s * safe_s) * relu_split(amt)

        return valid, safe_scale, safe_s, w_of, partial

    def rates(self, beam_e, e_loss, scale, s):
        """Poisson rates (W, F + 2) and conditional moments of the fine
        cells, the conditional e0 means of the two overflow cells and the
        law's mean."""
        n_samples, truncated = float(self.c.n_samples), self.c.truncated
        valid, safe_scale, safe_s, w_of, partial = self._law(
            beam_e, e_loss, scale, s)
        col = (..., None)
        w_edges = (beam_e[col] - self.edges - e_loss[col]) / safe_scale[col]
        if truncated:
            w_max = w_of(0.0)
            w_edges = torch.minimum(w_edges, w_max[col])
        logw = torch.log(torch.clamp_min(w_edges, 1e-30)) / safe_s[col]
        nd = ndtr(logw[..., None, :] - self.js[:, None]
                  * safe_s[..., None, None])
        amt = relu_split(nd[..., :-1] - nd[..., 1:])
        pm = torch.exp(0.5 * self.js * self.js * safe_s[col]
                       * safe_s[col])[..., None] * amt
        a_c = ((beam_e - self.t_ref - e_loss) / self.t_scale)[col]
        b_c = (safe_scale / self.t_scale)[col]
        pm0, pm1, pm2, pm3 = (pm[..., k, :] for k in range(4))
        s1 = a_c * pm0 - b_c * pm1
        s2 = a_c * a_c * pm0 - 2.0 * a_c * b_c * pm1 + b_c * b_c * pm2
        s3 = (a_c ** 3 * pm0 - 3.0 * a_c * a_c * b_c * pm1
              + 3.0 * a_c * b_c * b_c * pm2 - b_c ** 3 * pm3)
        moments = torch.stack([pm0, s1, s2, s3], dim=-2)
        zero = torch.zeros_like(safe_s)
        if truncated:
            norm_m = partial(0, zero, w_max)
            norm_m = torch.where(valid & (norm_m > 0), norm_m, 1.0)
        else:
            norm_m = torch.ones_like(safe_s)
        sbar = torch.where(valid[..., None, None],
                           moments * (n_samples / norm_m)[..., None, None],
                           0.0)
        s0 = sbar[..., 0, :]
        lam = torch.where(torch.isfinite(s0), torch.clamp_min(s0, 0.0), 0.0)
        m = sbar / torch.clamp_min(s0, 1e-12)[..., None, :]
        if truncated:
            w_max = w_of(0.0)
            norm = partial(0, zero, w_max)
            norm = torch.where(valid & (norm > 0), norm, 1.0)
            p0_below = partial(0, w_of(self.e0_lo), w_max)
            p1_below = partial(1, w_of(self.e0_lo), w_max)
        else:
            norm = torch.ones_like(safe_s)
            p0_below = partial(0, w_of(self.e0_lo), None)
            p1_below = partial(1, w_of(self.e0_lo), None)
        p0_above = partial(0, zero, w_of(self.e0_hi))
        p1_above = partial(1, zero, w_of(self.e0_hi))

        def cond_mean(p0, p1):
            return torch.where(p0 > 1e-30, beam_e - e_loss - safe_scale * p1
                               / torch.clamp_min(p0, 1e-30), 0.0)

        lam_below = torch.where(valid, n_samples * p0_below / norm, 0.0)
        lam_above = torch.where(valid, n_samples * p0_above / norm, 0.0)
        lam_all = torch.cat([lam, lam_below[..., None],
                             lam_above[..., None]], dim=-1)
        return (lam_all, m, cond_mean(p0_below, p1_below),
                cond_mean(p0_above, p1_above),
                self._mean(beam_e, e_loss, scale, s))

    def _mean(self, beam_e, e_loss, scale, s):
        valid = (scale > 0.0) & (s > 0.0)
        safe_scale = torch.where(scale > 0.0, scale, 1.0)
        safe_s = torch.where(s > 0.0, s, 1.0)
        if self.c.truncated:
            w_max = torch.clamp_min((beam_e - e_loss) / safe_scale, 1e-30)
            zmax = torch.log(w_max) / safe_s
            norm = ndtr(zmax)
            norm = torch.where(valid & (norm > 0), norm, 1.0)
            mean_w = torch.exp(0.5 * safe_s * safe_s) * ndtr(zmax - safe_s) \
                / norm
        else:
            mean_w = torch.exp(0.5 * safe_s * safe_s)
        return beam_e - e_loss - safe_scale * mean_w

    def grid_and_mean(self, params, generator):
        """(W, 4) beam parameters -> ((W, R, M, Be) grids, (W, R) e0
        means): one Poisson draw of every run's cells."""
        lam, m, mean_below, mean_above, mean_exp = self.rates(
            params[:, 0], params[:, 1], params[:, 2], params[:, 3])
        r = self.c.n_runs
        rates = lam[:, None, :].expand(lam.shape[0], r, lam.shape[1])
        counts = plain_k1.poisson_ptrs(rates.contiguous(),
                                       seed_words(generator))
        f = self.c.operator.n_fine
        m, lam_r = m[:, None], lam[:, None]
        mean_below, mean_above = mean_below[:, None], mean_above[:, None]
        cells = counts[..., :f]
        moments = cells[..., None, :] * torch.where(
            lam_r[..., None, :f] > 0, m, 0.0)
        cell_mean = self.t_ref + self.t_scale * m[..., 1, :]
        e0_sum = (torch.sum(cells * cell_mean, dim=-1)
                  + counts[..., f] * mean_below
                  + counts[..., f + 1] * mean_above)
        total = torch.sum(counts, dim=-1)
        e0_mean = torch.where(total > 0, e0_sum / torch.clamp_min(total, 1.0),
                              mean_exp[:, None])
        op = self.c.operator
        grids = self.matmul(moments.reshape(-1, 4 * f), self.a).reshape(
            moments.shape[:-2] + (op.n_x, op.n_ed))
        if self.atten is not None:
            grids = grids * self.atten[:, None]
        return grids, e0_mean

    def lattice(self, grids, e0_means):
        draws = grids / (torch.sum(grids, dim=(-2, -1), keepdim=True)
                         * self.area) * self.c.n_samples
        draws = torch.round(draws)
        eff_ed = (e0_means[..., None] + self.ed) / 2.0
        velocity = SPEED_OF_LIGHT * torch.sqrt(2.0 * eff_ed[..., None, :]
                                               / M_DEUTERON)
        base_tof = self.x[:, None] / velocity + self.tof_n
        return base_tof, draws.expand_as(base_tof)

    def histogram(self, base_tof, draws):
        """Every (x, eD) cell over the zero-degree segments into its run's
        window, np.histogram's rules; summed in float64, rounded once."""
        values = base_tof[..., None] + self.zt
        weights = (draws[..., None] * self.zw).to(torch.float64)
        lead = base_tof.shape[:-2]
        values = values.reshape(lead + (-1,))
        weights = weights.reshape(lead + (-1,))
        lo, hi = self.win_lo[:, None], self.win_hi[:, None]
        inside = (values >= lo) & (values <= hi)
        scaled = torch.floor((values - lo) * self.win_scale[:, None])
        idx = torch.where(inside, scaled, 0.0).to(torch.int64)
        idx = torch.minimum(torch.clamp_min(idx, 0), self.win_nb1[:, None])
        out = torch.zeros(lead + (self.n_pad,), dtype=torch.float64,
                          device=values.device)
        out.scatter_add_(-1, idx, torch.where(inside, weights, 0.0))
        return out.to(torch.float32)

    def spectra(self, thetas, generator):
        """(W, D) -> (W, R, n_pad) model spectra; the host ``generator``
        seeds the cells' draw, then (oneBD) the background's."""
        c = self.c
        r = c.n_runs
        if c.model == "simult":
            params, scales, bg = thetas[:, :4], thetas[:, 4:4 + r], None
        else:
            beam = torch.full_like(thetas[:, :1], 2490.0)
            params = torch.cat([beam, thetas[:, :3]], dim=-1)
            scales, bg = thetas[:, 3:3 + r], thetas[:, 3 + r:3 + 2 * r]
        grids, e0_means = self.grid_and_mean(params, generator)
        base_tof, draws = self.lattice(grids, e0_means)
        background = None
        if bg is not None:
            rates = bg[..., None].expand(bg.shape + (self.n_pad,))
            rates = plain_k1.poisson_ptrs(rates.contiguous(),
                                          seed_words(generator))
            background = torch.where(self.pad_mask, rates, 0.0)
        hist = self.histogram(base_tof, draws)
        hist = hist / (torch.sum(hist, dim=-1, keepdim=True)
                       * self.bin_widths)
        if self.expo is not None:
            hist = torch.where(self.pad_mask, self._conv(hist, self.expo),
                               0.0)
        hist = self._conv(hist, self.timing)
        out = torch.where(self.pad_mask, scales[..., None] * hist, 0.0)
        return out if background is None else out + background

    def _conv(self, spectra, mat):
        lead = spectra.shape[:-1]
        return self.matmul(spectra.reshape(-1, spectra.shape[-1]),
                           mat).reshape(lead + (mat.shape[-1],))

    def log_prob(self, thetas, generator):
        """Box prior + corrected Poisson log-likelihood, (W, D) -> (W,);
        NaN -> -inf."""
        thetas = thetas.to(device=self.device, dtype=torch.float32)
        ok = torch.all((thetas >= self.lo) & (thetas <= self.hi), dim=-1)
        prior = torch.where(ok, 0.0, -torch.inf)
        model = self.spectra(thetas, generator)
        rate = torch.clamp_min(model, 1e-3)
        obs = self.observed
        terms = obs * torch.log(rate) - rate - torch.lgamma(obs + 1.0)
        terms = torch.where(torch.isnan(model), -torch.inf, terms)
        per_run = torch.sum(torch.where(self.pad_mask, terms, 0.0), dim=-1)
        per_run = torch.where(torch.isnan(per_run), -torch.inf, per_run)
        like = torch.sum(per_run, dim=-1)
        like = torch.where(torch.isnan(like), -torch.inf, like)
        total = prior + like
        return torch.where(torch.isneginf(prior), -torch.inf,
                           torch.where(torch.isnan(total), -torch.inf, total))

