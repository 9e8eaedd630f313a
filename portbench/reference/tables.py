"""The static tables of the counts forward, built on the host in float64
numpy: the two campaigns' geometry and binnings, the d(d,n)3He cross
section, the stopping table E(e0, x), the e0-space preimage operator A,
the beam-timing and zero-degree kernels.

A frozen copy of the port's host arithmetic (its ``constants``,
``config``, ``ops/interp``, ``ops/xs``, ``ops/stopping``, ``ops/e0grid``
and ``ops/timing``), pruned to what the counts estimator of the simultFit
and csi_oneBD presets reads.  It imports nothing of the program: later
changes to the program are held against these tables, rebuilt here.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

SPEED_OF_LIGHT = 29.9792          # cm/ns
M_ELECTRON = 511.0                # keV/c^2
M_DEUTERON = 1.8756e06
M_NEUTRON = 939565.0
M_HE3 = 2.809414e6
Q_DDN = 3268.914                  # keV
AVOGADRO = 6.02214076e23
FIXED_FACTOR = 1.67489e-14        # (e^2 / 4 pi eps0)^2, keV-cm-ns units

CELL_LENGTH = 2.86                # cm, both campaigns
ZERO_DEG_LENGTH = 3.81


@dataclasses.dataclass(frozen=True)
class Binning:
    lo: float
    hi: float
    n: int

    @property
    def width(self) -> float:
        return (self.hi - self.lo) / self.n

    @property
    def centers(self) -> np.ndarray:
        w = self.width
        return np.linspace(self.lo + w / 2, self.hi - w / 2, self.n)

    @property
    def edges(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.n + 1)


@dataclasses.dataclass(frozen=True)
class Window:
    lo: float
    hi: float
    n_bins: int


# standoffs (cm) and TOF windows of each campaign's runs, in run order
_SIMULT_CLOSE = 148.4 + 233.8
_SIMULT_STANDOFF = {"close": _SIMULT_CLOSE, "mid": _SIMULT_CLOSE + 131.09,
                    "far": _SIMULT_CLOSE + 131.09 + 52.39,
                    "production": 59.45 + 355.7 + 2.341 + 148.4}
_SIMULT_WINDOW = {"close": Window(130.0, 175.0, 45),
                  "mid": Window(175.0, 225.0, 50),
                  "far": Window(190.0, 260.0, 70),
                  "production": Window(195.0, 260.0, 65)}
SIMULT_RUNS = ("mid", "close", "close", "far", "production")

_ONEBD_STANDOFF = {"close": 351.3, "mid": 351.3 + (412.3 - 351.3),
                   "far": 351.3 + (412.3 - 351.3) + (444.5 - 412.3)}
_ONEBD_WINDOW = {name: Window(lo, lo + 100.0, int(100.0 / 4))
                 for name, lo in (("close", 80.0), ("mid", 100.0),
                                  ("far", 120.0))}
ONEBD_RUNS = ("close", "mid", "far")


# --- the cross section -------------------------------------------------------

DDN_ENERGIES_KEV = np.concatenate([
    np.arange(20, 101, 10, dtype=np.float64),
    np.arange(150, 1001, 50, dtype=np.float64),
    np.arange(1100, 3001, 100, dtype=np.float64),
    np.arange(3500, 10001, 500, dtype=np.float64),
])
DDN_SIGMA_ZERO = np.array([
    0.025, 0.125, 0.31, 0.52, 0.78, 1.06, 1.35, 1.66, 2.00,
    3.33, 4.6, 5.9, 7.1, 8.3, 9.4, 10.4, 11.4, 12.4, 13.4, 14.3,
    15.1, 15.8, 16.5, 17.2, 17.8, 18.4, 19.0, 20.0, 21.0, 21.9,
    22.7, 23.4, 24.0, 24.6, 25.2, 25.8, 26.4, 26.9, 27.5, 28.0,
    28.4, 28.9, 29.3, 29.8, 30.3, 30.7, 31.2, 33.5, 35.7, 37.8,
    40.0, 41.5, 42.9, 43.8, 44.6, 45.2, 45.7, 46.1, 46.4, 46.5,
    46.5,
], dtype=np.float64)


def cubic_spline_coeffs(x, y) -> np.ndarray:
    """Not-a-knot cubic spline: (4, n-1, ...) coefficients, highest power
    first, of each interval [x_i, x_i+1] in (t - x_i)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    h = np.diff(x)
    y2 = y.reshape(n, -1)
    m = y2.shape[1]
    slope = np.diff(y2, axis=0) / h[:, None]
    a = np.zeros((n, n))
    b = np.zeros((n, m))
    for i in range(1, n - 1):
        a[i, i - 1] = h[i]
        a[i, i] = 2.0 * (h[i] + h[i - 1])
        a[i, i + 1] = h[i - 1]
        b[i] = 3.0 * (h[i] * slope[i - 1] + h[i - 1] * slope[i])
    a[0, 0] = h[1]
    a[0, 1] = h[0] + h[1]
    b[0] = ((h[0] + 2.0 * (h[0] + h[1])) * h[1] * slope[0]
            + h[0] * h[0] * slope[1]) / (h[0] + h[1])
    a[-1, -2] = h[-1] + h[-2]
    a[-1, -1] = h[-2]
    b[-1] = ((h[-1] * h[-1] * slope[-2]
              + (2.0 * (h[-1] + h[-2]) + h[-1]) * h[-2] * slope[-1])
             / (h[-1] + h[-2]))
    s = np.linalg.solve(a, b)
    s0, s1, hh = s[:-1], s[1:], h[:, None]
    coeffs = np.stack([(s0 + s1 - 2.0 * slope) / (hh * hh),
                       (3.0 * slope - 2.0 * s0 - s1) / hh, s0, y2[:-1]])
    return coeffs.reshape((4, n - 1) + y.shape[1:])


class UniformXS:
    """sigma_DDN(E_d): the not-a-knot spline of the table, queries clamped
    to [20, 10000] keV, re-segmented onto a uniform 10 keV grid (exact:
    10 keV divides every knot spacing)."""

    def __init__(self, step: float = 10.0):
        knots = DDN_ENERGIES_KEV
        coeffs = cubic_spline_coeffs(knots, DDN_SIGMA_ZERO)
        lo, hi = float(knots[0]), float(knots[-1])
        n_cells = int(round((hi - lo) / step))
        starts = lo + step * np.arange(n_cells)
        seg = np.clip(np.searchsorted(knots, starts + 1e-9 * step,
                                      side="right") - 1, 0, len(knots) - 2)
        d = starts - knots[seg]
        c3, c2, c1, c0 = (coeffs[k][seg] for k in range(4))
        self.lo, self.step = lo, step
        self.clamp = (20.0, 10000.0)
        self.coeffs = np.stack([c3, 3 * c3 * d + c2,
                                3 * c3 * d * d + 2 * c2 * d + c1,
                                ((c3 * d + c2) * d + c1) * d + c0])

    def __call__(self, t) -> np.ndarray:
        tc = np.clip(np.asarray(t, dtype=np.float64), *self.clamp)
        n_cells = self.coeffs.shape[1]
        idx = np.clip(((tc - self.lo) / self.step).astype(np.int64), 0,
                      n_cells - 1)
        dt = tc - (self.lo + self.step * idx)
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        return ((c3 * dt + c2) * dt + c1) * dt + c0


# --- stopping in the gas and the transport table ----------------------------

def _rk4_transport_np(rho, e0, x_eval, n_substeps, energy_floor=None):
    """f64 RK4 of the Bethe dE/dx of a deuteron in D2 gas (Z 1, A 2,
    density ``rho`` g/cm^3, mean excitation 19.2 eV) through the depths."""
    n_e = np.array([AVOGADRO * 1.0 * rho / 2.0])
    excitations = np.array([19.2e-3])

    def dedx(e):
        v2 = 2.0 * e / M_DEUTERON * SPEED_OF_LIGHT ** 2
        leading = 4.0 * np.pi / (M_ELECTRON * SPEED_OF_LIGHT ** 2 * v2)
        log_arg = (2.0 * M_ELECTRON / SPEED_OF_LIGHT ** 2 * v2[..., None]
                   / excitations)
        return -leading * FIXED_FACTOR * np.sum(n_e * np.log(log_arg),
                                                axis=-1)

    e = np.array(e0, dtype=np.float64)
    out = np.empty((len(e), len(x_eval)))
    x_prev = 0.0
    for j, x in enumerate(x_eval):
        h = (x - x_prev) / n_substeps
        for _ in range(n_substeps):
            if energy_floor is None:
                k1 = dedx(e)
                k2 = dedx(e + 0.5 * h * k1)
                k3 = dedx(e + 0.5 * h * k2)
                k4 = dedx(e + h * k3)
                e = e + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            else:
                f = energy_floor
                stopped = e <= f
                e_safe = np.maximum(e, f)
                k1 = dedx(e_safe)
                k2 = dedx(np.maximum(e_safe + 0.5 * h * k1, f))
                k3 = dedx(np.maximum(e_safe + 0.5 * h * k2, f))
                k4 = dedx(np.maximum(e_safe + h * k3, f))
                e_new = np.maximum(
                    e_safe + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), f)
                e = np.where(stopped, e, e_new)
        out[:, j] = e
        x_prev = x
    return out


@dataclasses.dataclass(frozen=True)
class StoppingTable:
    e0_grid: np.ndarray       # (G,)
    coeffs: np.ndarray        # (4, G-1, M)

    @classmethod
    def build(cls, rho, e0_bins, x_centers, energy_floor=None):
        lo, hi, step = e0_bins
        e0_grid = np.arange(lo, hi, step, dtype=np.float64)
        table = _rk4_transport_np(rho, e0_grid,
                                  np.asarray(x_centers, np.float64), 64,
                                  energy_floor)
        return cls(e0_grid, cubic_spline_coeffs(e0_grid, table))

    def __call__(self, e0) -> np.ndarray:
        """E at every depth, (K,) -> (K, M), clip + Horner."""
        e0 = np.asarray(e0, dtype=np.float64)
        lo = float(self.e0_grid[0])
        step = float(self.e0_grid[1] - self.e0_grid[0])
        idx = np.clip(((e0 - lo) / step).astype(np.int64), 0,
                      self.e0_grid.shape[0] - 2)
        dt = (e0 - (lo + step * idx))[:, None]
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        return ((c3 * dt + c2) * dt + c1) * dt + c0


# --- the e0-space preimage operator -----------------------------------------

@dataclasses.dataclass(frozen=True)
class E0Operator:
    """Fine-cell raw t-moments (4 F) -> (x, eD) grid (M Be), rows
    channel-major, t = (e0 - t_ref) / t_scale."""

    e0_lo: float
    e0_hi: float
    n_fine: int
    t_ref: float
    t_scale: float
    a_matrix: np.ndarray      # (4 F, M Be) float32
    n_x: int
    n_ed: int


def build_e0_operator(table: StoppingTable, ed: Binning, n_x: int,
                      n_fine: int, n_invert: int = 20001) -> E0Operator:
    """Invert E(., x_m) at the eD edges, fit sigma(E(e0, x_m)) by a cubic
    on each fine cell (Chebyshev nodes), and integrate each (x, eD)
    preimage over the cells (boundary cells by the linear-density model)."""
    xs = UniformXS()
    n_ed = ed.n
    e0_dense = np.linspace(float(table.e0_grid[0]), float(table.e0_grid[-1]),
                           n_invert)
    e_dense = table(e0_dense)                               # (K, M)
    ed_edges = np.asarray(ed.edges, dtype=np.float64)
    z = np.empty((n_x, n_ed + 1))
    for m in range(n_x):
        col = e_dense[:, m]
        if not np.all(np.diff(col) > 0):
            col = np.maximum.accumulate(col)
            col = col + np.arange(col.size) * 1e-9
        z[m] = np.interp(ed_edges, col, e0_dense)

    lo, hi = float(z.min()), float(z.max())
    span = hi - lo
    lo -= 1e-6 * span
    hi += 1e-6 * span
    cell_w = (hi - lo) / n_fine
    t_ref, t_scale = 0.5 * (lo + hi), 0.5 * (hi - lo)

    def to_t(e0):
        return (np.asarray(e0) - t_ref) / t_scale

    cell_edges = lo + cell_w * np.arange(n_fine + 1)
    cell_edges_t = to_t(cell_edges)
    h_t = cell_edges_t[1] - cell_edges_t[0]

    cheb = 0.5 * (1.0 + np.cos(np.pi * (2 * np.arange(4) + 1) / 8.0))[::-1]
    nodes = cell_edges[:-1, None] + cell_w * cheb[None, :]   # (F, 4)
    e_nodes = table(nodes.reshape(-1))                       # (F*4, M)
    g_nodes = xs(e_nodes.T.reshape(-1)).reshape(n_x, n_fine, 4)
    vand = to_t(nodes)[:, :, None] ** np.arange(4)[None, None, :]
    c = np.linalg.solve(np.broadcast_to(vand, (n_x, n_fine, 4, 4)),
                        g_nodes[..., None])[..., 0]          # (M, F, 4)

    a_mat = np.zeros((4, n_fine, n_x, n_ed))
    z_t = to_t(z)
    pows = np.arange(1, 6, dtype=np.float64)
    for m in range(n_x):
        zt = z_t[m]
        f_lo = np.clip(np.floor((zt[:-1] - cell_edges_t[0]) / h_t
                                ).astype(np.int64), 0, n_fine - 1)
        f_hi = np.clip(np.floor((zt[1:] - cell_edges_t[0]) / h_t
                                ).astype(np.int64), 0, n_fine - 1)
        for b in range(n_ed):
            if zt[b + 1] <= zt[b]:
                continue
            fa, fb = int(f_lo[b]), int(f_hi[b])
            if fb - fa >= 2:
                full = np.arange(fa + 1, fb)
                a_mat[:, full, m, b] += c[m, full, :].T
            for f in range(fa, fb + 1):
                if fa < f < fb:
                    continue
                s0 = max(zt[b], cell_edges_t[f])
                s1 = min(zt[b + 1], cell_edges_t[f + 1])
                if s1 <= s0:
                    continue
                if (s0 <= cell_edges_t[f] + 1e-12 * abs(h_t)
                        and s1 >= cell_edges_t[f + 1] - 1e-12 * abs(h_t)):
                    a_mat[:, f, m, b] += c[m, f, :]
                    continue
                tc = 0.5 * (cell_edges_t[f] + cell_edges_t[f + 1])
                ints = (s1 ** pows - s0 ** pows) / pows
                i_k = ints[:4]
                j_k = ints[1:5] - tc * ints[:4]
                a_mat[0, f, m, b] += float(np.dot(
                    c[m, f], i_k / h_t - 12.0 * tc * j_k / h_t ** 3))
                a_mat[1, f, m, b] += float(np.dot(c[m, f],
                                                  12.0 * j_k / h_t ** 3))
    return E0Operator(lo, hi, n_fine, t_ref, t_scale,
                      a_mat.reshape(4 * n_fine, n_x * n_ed).astype(
                          np.float32), n_x, n_ed)


# --- timing -------------------------------------------------------------------

def exgaussian_kernel(sigma=1.1910, tau=1.0110, bin_width=1.0):
    lo, hi = np.ceil(-5.0 * sigma), np.ceil(10.0 * tau)
    t = np.linspace(lo + bin_width / 2, hi - bin_width / 2, int(hi - lo))
    exp_arg = sigma ** 2 / (2.0 * tau ** 2) - t / tau
    erf_arg = (sigma ** 2 - t * tau) / (np.sqrt(2.0) * sigma * tau)
    vals = np.exp(exp_arg) * np.array([math.erfc(a) for a in erf_arg])
    return vals / vals.sum()


def gaussian_kernel(sigma):
    centers = np.linspace(-20.0, 20.0, 11)
    vals = np.exp(-((centers / sigma) ** 2) / 2.0)
    return vals / vals.sum()


def expo_kernel():
    vals = np.exp(-np.linspace(0.0, 24.0, 7) / 2.0)
    return vals / vals.sum()


def same_conv_matrix(kernel, n):
    """x @ T == np.convolve(x, kernel, 'same')."""
    kernel = np.asarray(kernel, dtype=np.float64)
    off = (len(kernel) - 1) // 2
    tap = np.arange(n)[None, :] + off - np.arange(n)[:, None]
    valid = (tap >= 0) & (tap < len(kernel))
    return np.where(valid, kernel[np.clip(tap, 0, len(kernel) - 1)], 0.0)


def causal_conv_matrix(kernel, n):
    """x @ T == np.convolve(x, kernel, 'full')[:n]."""
    kernel = np.asarray(kernel, dtype=np.float64)
    tap = np.arange(n)[None, :] - np.arange(n)[:, None]
    valid = (tap >= 0) & (tap < len(kernel))
    return np.where(valid, kernel[np.clip(tap, 0, len(kernel) - 1)], 0.0)


def tof_np(mass, energy, distance):
    """Time of flight (ns) in the dtype of the inputs."""
    energy = np.asarray(energy)
    dt = np.result_type(energy, np.asarray(distance))
    velocity = dt.type(SPEED_OF_LIGHT) * np.sqrt(
        dt.type(2.0) * energy / dt.type(mass))
    return np.asarray(distance, dtype=dt) / velocity


def dd_neutron_energy_np(e_d):
    e_d = np.asarray(e_d, dtype=np.float64)
    r = np.sqrt(M_DEUTERON * M_NEUTRON * e_d) / (M_NEUTRON + M_HE3)
    s = (e_d * (M_HE3 - M_DEUTERON) + Q_DDN * M_HE3) / (M_NEUTRON + M_HE3)
    return (r + np.sqrt(r * r + s)) ** 2


def zero_degree_segments(neutron_energy, n_segments=10):
    """(Be, K) transit times and weights of the 10 detector segments,
    float32 (n-p elastic attenuation, Marion and Young)."""
    seg = ZERO_DEG_LENGTH / n_segments
    e = np.asarray(neutron_energy, dtype=np.float32)[..., None]
    x = np.linspace(seg / 2, ZERO_DEG_LENGTH - seg / 2,
                    n_segments).astype(np.float32)
    tofs = tof_np(M_NEUTRON, e, x)
    xs = (np.float32(4.83) / np.sqrt(e / np.float32(1000.0))
          - np.float32(0.578)) * np.float32(1e-24)
    weights = np.exp(-xs * np.float32(4.82e22) * x)
    return tofs, weights / np.sum(weights, axis=-1, keepdims=True)


# --- a campaign -----------------------------------------------------------------

@dataclasses.dataclass
class Campaign:
    """Everything static of one counts fit, in numpy."""

    model: str
    n_runs: int
    n_samples: int
    truncated: bool
    ed: Binning
    x: Binning
    operator: E0Operator
    a_bfloat16: bool
    standoffs: tuple
    windows: tuple
    timing_kernel: np.ndarray
    zero_degree: str              # 'segments' or 'expo'
    zt: np.ndarray                # (Be, K)
    zw: np.ndarray
    attenuation: np.ndarray | None   # (M,) or None
    background: bool
    param_lo: np.ndarray
    param_hi: np.ndarray


def campaign(config: dict, traffic: dict) -> Campaign:
    """The campaign of a configuration file under a counts traffic mix."""
    model, n_samples = config["model"], int(config["n_samples"])
    n_runs = int(config["n_runs"])
    if model == "simult":
        rho = 8.565e-5
        ed, x = Binning(200.0, 1200.0, 50), Binning(0.0, CELL_LENGTH, 10)
        table = StoppingTable.build(rho, (20.0, 2420.0, 25.0), x.centers,
                                    energy_floor=20.0)
        n_fine = 512 if n_samples >= 100_000 else 1024
        names = SIMULT_RUNS[:n_runs]
        standoffs = tuple(_SIMULT_STANDOFF[n] for n in names)
        windows = tuple(_SIMULT_WINDOW[n] for n in names)
        timing = exgaussian_kernel()
        zt, zw = zero_degree_segments(dd_neutron_energy_np(ed.centers))
        zero_degree, attenuation, background = "segments", None, False
        truncated, a_bf16 = True, False
        lo = np.concatenate([[1825.0, 600.0, 40.0, 0.1],
                             np.full(n_runs, 0.0)])
        hi = np.concatenate([[1925.0, 1000.0, 300.0, 1.2],
                             np.full(n_runs, 1.0e6)])
    elif model == "onebd":
        rho = 4 * 8.565e-5
        n_ed, n_x = (400, 20) if config.get("hardcore") else (100, 10)
        ed, x = Binning(200.0, 2200.0, n_ed), Binning(0.0, CELL_LENGTH, n_x)
        table = StoppingTable.build(rho, (100.0, 2400.0, 100.0), x.centers)
        n_fine = 1024 if n_samples >= 100_000 else 2048
        names = ONEBD_RUNS[:n_runs]
        standoffs = tuple(_ONEBD_STANDOFF[n] for n in names)
        windows = tuple(_ONEBD_WINDOW[n] for n in names)
        timing = gaussian_kernel(2.7)
        zt = np.zeros((n_ed, 1), np.float32)
        zw = np.ones((n_ed, 1), np.float32)
        zero_degree, background = "expo", True
        attenuation = np.exp(-x.centers / 20.0)
        truncated, a_bf16 = False, bool(config.get("hardcore"))
        lo = np.concatenate([[200.0, 10.0, 0.05], np.full(n_runs, 1e3),
                             np.full(n_runs, 0.0)])
        hi = np.concatenate([[2000.0, 700.0, 3.0], np.full(n_runs, 1.0e8),
                             np.full(n_runs, 1e3)])
    else:
        raise ValueError(f"unknown model {model!r}")
    if traffic.get("fine_grid") is not None:
        n_fine = int(traffic["fine_grid"])
    operator = build_e0_operator(table, ed, x.n, n_fine)
    return Campaign(model, n_runs, n_samples, truncated, ed, x, operator,
                    a_bf16, standoffs, windows, timing, zero_degree, zt, zw,
                    attenuation, background, lo, hi)
