"""Gather-free (x, eD) weight grid via static e0-space preimages.

Port of ``mcmctoffitting_tpu/ops/e0grid.py``.  The transport map E(e0, x)
does not depend on the fitted parameters, so its preimages are inverted
once on the host (f64 numpy, :func:`build_e0_grid_table`) into a static
linear operator A from per-fine-cell raw t-moments (S0..S3) to the
(x, eD) grid; at run time the grid is one matmul ``S @ A``.

The run-time half works on batched tensors: parameters of any leading
shape (...), moments (..., 4, F).  The mc estimator sums the moments of
its drawn initial energies (:func:`fine_cell_moments`), the 'expected'
estimator takes them in closed form (:func:`expected_moments`).  The
counts estimator is split into its
three parts so that each can be tested alone:

1. :func:`counts_lambdas` — closed-form Poisson rates of the F fine cells
   plus the two overflow cells, and the conditional moments;
2. the Poisson draw (``ops/cuda_poisson.poisson``, kernel K1);
3. :func:`moments_from_counts` — deterministic core, counts -> (moments,
   e0 mean).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .fixed_point import channel_shifts, dequantise, quantise
from .pdfs import ndtr
from .rowwise import rowwise_matmul

# bounds of the fine-cell channels (1, t, t^2, t^3) over [e0_lo, e0_hi]
MOMENT_BOUNDS = (1.0, 1.0, 1.0, 1.0)


def _eval_table_np(table, e0):
    """Host f64 stopping-table lookup (clip + Horner): (K,) -> (K, M)."""
    e0 = np.asarray(e0, dtype=np.float64)
    lo = float(table.e0_grid[0])
    step = float(table.e0_grid[1] - table.e0_grid[0])
    n_seg = table.e0_grid.shape[0] - 1
    idx = np.clip(((e0 - lo) / step).astype(np.int64), 0, n_seg - 1)
    dt = (e0 - (lo + step * idx))[:, None]
    c3, c2, c1, c0 = (table.coeffs[k][idx] for k in range(4))  # (K, M)
    return ((c3 * dt + c2) * dt + c1) * dt + c0


@dataclasses.dataclass(frozen=True)
class E0GridTable:
    """Static e0-space grid operator: fine-cell moments -> (M, Be) grid.

    ``a_matrix`` is (4*F, M*Be) f32, rows channel-major (channel k of fine
    cell f at row ``k * F + f``), columns ``m * Be + b``; ``t_ref`` and
    ``t_scale`` normalise t = (e0 - t_ref) / t_scale.
    """

    e0_lo: float
    e0_hi: float
    n_fine: int
    t_ref: float
    t_scale: float
    a_matrix: np.ndarray      # (4 * F, M * Be) f32
    n_x: int
    n_ed: int
    ed_lo: float = 0.0
    ed_hi: float = 0.0

    def __post_init__(self):
        object.__setattr__(
            self, "_hash",
            hash((self.e0_lo, self.e0_hi, self.n_fine, self.t_ref,
                  self.t_scale, self.n_x, self.n_ed, self.ed_lo,
                  self.ed_hi, self.a_matrix.tobytes())))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, E0GridTable)
                and self._hash == other._hash
                and np.array_equal(self.a_matrix, other.a_matrix))


def build_e0_grid_table(stopping_table, ed_binning, xs,
                        n_fine: int = 1024,
                        n_invert: int = 20001) -> E0GridTable:
    """Compile (stopping table, eD binning, XS spline) into an E0GridTable
    (host f64, the JAX package's arithmetic)."""
    table = stopping_table
    eb = ed_binning
    n_x = int(table.x_centers.shape[0])
    n_ed = int(eb.n)

    # --- 1. preimage edges z[m, b] by monotone inversion of E(., x_m)
    e0_dense = np.linspace(float(table.e0_grid[0]),
                           float(table.e0_grid[-1]), n_invert)
    e_dense = _eval_table_np(table, e0_dense)              # (K, M)
    ed_edges = np.asarray(eb.edges, dtype=np.float64)      # (Be + 1,)
    z = np.empty((n_x, n_ed + 1))
    for m in range(n_x):
        col = e_dense[:, m]
        d = np.diff(col)
        if not np.all(d > 0):
            # flat spots from the energy floor: nudge monotone
            col = np.maximum.accumulate(col)
            col = col + np.arange(col.size) * 1e-9
        z[m] = np.interp(ed_edges, col, e0_dense)

    lo = float(z.min())
    hi = float(z.max())
    span = hi - lo
    lo -= 1e-6 * span
    hi += 1e-6 * span
    cell_w = (hi - lo) / n_fine
    t_ref = 0.5 * (lo + hi)
    t_scale = 0.5 * (hi - lo)

    def to_t(e0):
        return (np.asarray(e0) - t_ref) / t_scale

    cell_edges = lo + cell_w * np.arange(n_fine + 1)
    cell_edges_t = to_t(cell_edges)
    h_t = cell_edges_t[1] - cell_edges_t[0]

    # --- 2. per-(slice, cell) cubic fits of g_m(e0) = sigma(E(e0, x_m))
    cheb = 0.5 * (1.0 + np.cos(np.pi * (2 * np.arange(4) + 1) / 8.0))[::-1]
    nodes = cell_edges[:-1, None] + cell_w * cheb[None, :]   # (F, 4)
    nodes_t = to_t(nodes)
    e_nodes = _eval_table_np(table, nodes.reshape(-1))       # (F*4, M)
    g_nodes = xs.eval_np(e_nodes.T.reshape(-1)).reshape(n_x, n_fine, 4)
    vand = nodes_t[:, :, None] ** np.arange(4)[None, None, :]  # (F, 4, 4)
    c = np.linalg.solve(np.broadcast_to(vand, (n_x, n_fine, 4, 4)),
                        g_nodes[..., None])[..., 0]          # (M, F, 4)

    # --- 3. assemble A; boundary cells split by the linear-density model
    # rho(t) = a + b (t - tc), a = S0/h, b = 12 (S1 - tc S0) / h^3
    a_mat = np.zeros((4, n_fine, n_x, n_ed))

    z_t = to_t(z)                                            # (M, Be+1)
    pows = np.arange(1, 6, dtype=np.float64)

    def ikjk(s0, s1, tc):
        """I_k = int t^k and J_k = int (t - tc) t^k over [s0, s1]."""
        p0 = s0[..., None] ** pows
        p1 = s1[..., None] ** pows
        ints = (p1 - p0) / pows
        i_k = ints[..., :4]
        j_k = ints[..., 1:5] - tc[..., None] * ints[..., :4]
        return i_k, j_k

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
                i_k, j_k = ikjk(np.asarray(s0), np.asarray(s1),
                                np.asarray(tc))
                alpha = float(np.dot(c[m, f],
                                     i_k / h_t - 12.0 * tc * j_k / h_t ** 3))
                beta = float(np.dot(c[m, f], 12.0 * j_k / h_t ** 3))
                a_mat[0, f, m, b] += alpha
                a_mat[1, f, m, b] += beta

    a_flat = a_mat.reshape(4 * n_fine, n_x * n_ed).astype(np.float32)
    return E0GridTable(lo, hi, n_fine, t_ref, t_scale, a_flat, n_x, n_ed,
                       float(eb.lo), float(eb.hi))


@functools.lru_cache(maxsize=8)
def cached_e0_grid_table(stopping_table, ed_binning, xs,
                         n_fine: int) -> E0GridTable:
    """lru-cached :func:`build_e0_grid_table` (all arguments are hashable
    frozen objects)."""
    return build_e0_grid_table(stopping_table, ed_binning, xs,
                               n_fine=n_fine)


class E0Grid(torch.nn.Module):
    """Device view of an :class:`E0GridTable`: the A operator and the
    fine-cell edges as buffers, the scalar constants as Python floats."""

    def __init__(self, table: E0GridTable, *, device,
                 a_dtype: str = "float32"):
        """``a_dtype='bfloat16'`` rounds A to bfloat16 (to nearest even)
        and keeps the rounded values as float32, so that :func:`contract`
        reads them as they are."""
        super().__init__()
        if a_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"E0Grid: a_dtype {a_dtype!r}")
        self.e0_lo = float(table.e0_lo)
        self.e0_hi = float(table.e0_hi)
        self.n_fine = int(table.n_fine)
        self.t_ref = float(table.t_ref)
        self.t_scale = float(table.t_scale)
        self.n_x = int(table.n_x)
        self.n_ed = int(table.n_ed)
        f = self.n_fine
        edges = self.e0_lo + (self.e0_hi - self.e0_lo) / f * np.arange(f + 1)
        edges = torch.as_tensor(edges, dtype=torch.float32, device=device)
        self.register_buffer("edges", edges)                  # (F+1,)
        self.register_buffer("t_edges", (edges - self.t_ref) / self.t_scale)
        a_matrix = torch.as_tensor(table.a_matrix, dtype=torch.float32,
                                   device=device)
        if a_dtype == "bfloat16":
            a_matrix = a_matrix.to(torch.bfloat16).to(torch.float32)
        self.register_buffer("a_matrix", a_matrix)
        self.register_buffer("js", torch.arange(4, dtype=torch.float32,
                                                device=device))

    def float64(self) -> "E0Grid":
        """A float64 copy of this grid's buffers (the float32 values,
        widened), made once per device: the precision in which
        :func:`expected_grid` differentiates."""
        copy = self.__dict__.get("_float64")
        if copy is None or copy.a_matrix.device != self.a_matrix.device:
            copy = E0Grid.__new__(E0Grid)
            torch.nn.Module.__init__(copy)
            copy.__dict__.update({k: v for k, v in self.__dict__.items()
                                  if not k.startswith("_")})
            for name, buf in self.named_buffers():
                copy.register_buffer(name, buf.double())
            self.__dict__["_float64"] = copy   # not a submodule
        return copy


def contract(grid: E0Grid, moments: torch.Tensor) -> torch.Tensor:
    """(..., 4, F) fine-cell moments -> (..., M, Be) grid: a float32
    matmul (rows, 4F) @ (4F, M*Be) against the static A operator, in
    blocks of a fixed row count (``ops/rowwise.rowwise_matmul``: a
    walker's grid does not depend on the batch it is evaluated in).  The moments are
    never rounded, whatever A was rounded to (the cubic reconstruction
    cancels across the four channel rows, so rounding the moments too
    would cost several percent of the grid)."""
    lead = moments.shape[:-2]
    flat = moments.reshape(-1, 4 * grid.n_fine)
    return rowwise_matmul(flat, grid.a_matrix).reshape(
        lead + (grid.n_x, grid.n_ed))


def fine_cell_moments(grid: E0Grid, e0: torch.Tensor) -> torch.Tensor:
    """Raw t-moments of drawn initial energies per fine cell:
    (..., N) -> (..., 4, F), the sums of base, base t, base t^2 and
    base t^2 t over the samples of each cell, with cell =
    clip(floor((e0 - e0_lo) F / (e0_hi - e0_lo)), 0, F - 1), base = 1
    inside the closed range [e0_lo, e0_hi] and 0 outside (NaN included)
    and t = (e0 - t_ref) / t_scale.

    The channel values are float32, as in the JAX package; each is summed
    as an int64 fixed-point number (``ops/fixed_point``, |t| <= 1 in range
    since t_ref and t_scale are the centre and half-width of [e0_lo,
    e0_hi]) by one ``scatter_add_`` per channel, and the sums are rounded
    to float32 once.  Integer sums do not depend on the order of the
    additions, so the result is the same on every call, and on the CPU and
    the GPU, for the same energies."""
    f = grid.n_fine
    lead, n = e0.shape[:-1], e0.shape[-1]
    rows = e0.reshape(-1, n)
    inv_cell = f / (grid.e0_hi - grid.e0_lo)
    inv_tscale = 1.0 / grid.t_scale
    in_range = (rows >= grid.e0_lo) & (rows <= grid.e0_hi)
    u = torch.floor((rows - grid.e0_lo) * inv_cell)
    idx = torch.clamp(torch.where(in_range, u, 0.0), 0, f - 1).to(torch.int64)
    base = in_range.to(rows.dtype)
    t = torch.where(in_range, (rows - grid.t_ref) * inv_tscale, 0.0)
    t2 = t * t
    shifts = channel_shifts(max(1, n), MOMENT_BOUNDS)
    out = torch.zeros((4, rows.shape[0], f), dtype=torch.int64,
                      device=rows.device)
    for k, chan in enumerate((base, base * t, base * t2, base * t2 * t)):
        out[k].scatter_add_(-1, idx, quantise(chan, shifts[k:k + 1]))
    return dequantise(out, shifts, 0).movedim(0, 1).reshape(lead + (4, f))


def relu_split(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the gradient of ``jnp.maximum(x, 0.0)``: half of it
    at x == 0 (``torch.clamp_min`` passes all of it).  The value is
    max(x, 0) bit for bit (x + |x| is exactly 2x or 0).  The tie is
    common here: where both ndtr edges of a cell saturate, their difference
    is exactly 0, and its derivative is not."""
    return 0.5 * (x + torch.abs(x))


def _lognorm_w_machinery(beam_e, e_loss, scale, s):
    """Shared guards + partial moments of the lognormal beam law.

    Returns (valid, safe_scale, safe_s, w_of, partial) where
    ``w_of(e0) = (beamE - e0 - eLoss)/scale`` and ``partial(j, lo, hi)``
    is E[W^j; lo < W < hi] for W = exp(s Z) (``hi=None`` means +inf).
    Parameters have any common shape (...); ``lo``/``hi`` broadcast to it.
    """
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
        return (torch.exp(0.5 * j * j * safe_s * safe_s)
                * relu_split(amt))

    return valid, safe_scale, safe_s, w_of, partial


def expected_moments(grid: E0Grid, beam_e, e_loss, scale, s,
                     n_samples: float, truncated: bool,
                     closure: str = "exact"):
    """Closed-form fine-cell moments under the lognormal beam density.

    e0 = beamE - eLoss - scale W with W = exp(s Z); t is affine in W, so
    every raw t-moment of a cell expands into partial moments of W, each a
    difference of ndtr at the cell edges.  ``truncated`` conditions on
    e0 > 0; ``closure`` is 'exact' (full (4, F+1) ndtr chain) or 'cell'
    (mass + mean from the chain, t^2/t^3 closed by the within-cell linear
    density).

    Parameters (...,) -> (S (..., 4, F) scaled to ``n_samples`` draws,
    e0_mean (...,)).
    """
    if closure not in ("exact", "cell"):
        raise ValueError(f"unknown moment closure {closure!r} "
                         "(expected 'exact' or 'cell')")
    valid, safe_scale, safe_s, w_of, partial = _lognorm_w_machinery(
        beam_e, e_loss, scale, s)
    col = (..., None)

    # e0 cell [a, b] -> W interval (the map is decreasing in W)
    w_edges = (beam_e[col] - grid.edges - e_loss[col]) / safe_scale[col]
    if truncated:
        w_max = w_of(0.0)
        w_edges = torch.minimum(w_edges, w_max[col])

    # adjacent cells share an edge: one ndtr chain over the F+1 edges
    n_rows = 4 if closure == "exact" else 2
    js = grid.js[:n_rows]
    logw = torch.log(torch.clamp_min(w_edges, 1e-30)) / safe_s[col]
    nd = ndtr(logw[..., None, :]
                            - js[:, None] * safe_s[..., None, None])
    amt = relu_split(nd[..., :-1] - nd[..., 1:])              # (..., n, F)
    pm = torch.exp(0.5 * js * js * safe_s[col] * safe_s[col])[..., None] * amt

    # t = A - B W with A = (beamE - t_ref - eLoss)/t_scale, B = scale/t_scale
    a_c = ((beam_e - grid.t_ref - e_loss) / grid.t_scale)[col]
    b_c = (safe_scale / grid.t_scale)[col]
    pm0, pm1 = pm[..., 0, :], pm[..., 1, :]
    s0 = pm0
    s1 = a_c * pm0 - b_c * pm1
    if closure == "exact":
        pm2, pm3 = pm[..., 2, :], pm[..., 3, :]
        s2 = a_c * a_c * pm0 - 2.0 * a_c * b_c * pm1 + b_c * b_c * pm2
        s3 = (a_c ** 3 * pm0 - 3.0 * a_c * a_c * b_c * pm1
              + 3.0 * a_c * b_c * b_c * pm2 - b_c ** 3 * pm3)
    else:
        # within-cell linear density pinned by the exact conditional mean:
        # Var = h^2/12 - dm^2, mu3 = -0.1 dm h^2 + 2 dm^3 (dm = mean offset)
        t_edges = grid.t_edges
        h = (grid.e0_hi - grid.e0_lo) / (grid.n_fine * grid.t_scale)
        t_c = 0.5 * (t_edges[:-1] + t_edges[1:])
        m1 = torch.minimum(
            torch.maximum(s1 / torch.clamp_min(s0, 1e-12), t_edges[:-1]),
            t_edges[1:])
        dm = m1 - t_c
        v = relu_split(h * h / 12.0 - dm * dm)
        mu3 = (2.0 * dm * dm - 0.1 * h * h) * dm
        s2 = s0 * (m1 * m1 + v)
        s3 = s0 * (m1 * (m1 * m1 + 3.0 * v) + mu3)
    moments = torch.stack([s0, s1, s2, s3], dim=-2)         # (..., 4, F)

    if truncated:
        zero = torch.zeros_like(w_max)
        norm = partial(0, zero, w_max)
        mean_w = partial(1, zero, w_max)
        norm = torch.where(valid & (norm > 0), norm, 1.0)
    else:
        norm = torch.ones_like(safe_s)
        mean_w = torch.exp(0.5 * safe_s * safe_s)

    moments = torch.where(valid[..., None, None],
                          moments * (n_samples / norm)[..., None, None], 0.0)
    e0_mean = beam_e - e_loss - safe_scale * mean_w / norm
    return moments, e0_mean


class CountsRates(NamedTuple):
    """Per-parameter-point inputs of the counts estimator (all (...) or
    (..., ·) tensors over the parameter shape)."""

    lam: torch.Tensor             # (..., F+2): F cells, below, above
    m: torch.Tensor               # (..., 4, F) conditional t-moments
    mean_below: torch.Tensor      # (...) e0 mean of draws below the grid
    mean_above: torch.Tensor      # (...) e0 mean of draws above the grid
    e0_mean_expected: torch.Tensor  # (...) fallback when nothing is drawn


def counts_lambdas(grid: E0Grid, beam_e, e_loss, scale, s,
                   n_samples: float, truncated: bool,
                   closure: str = "exact") -> CountsRates:
    """Part 1 of the counts estimator: the Poisson rates of the F fine
    cells and of the two overflow cells (draws below/above the grid, which
    enter only the e0 sample mean), with their conditional moments."""
    sbar, _ = expected_moments(grid, beam_e, e_loss, scale, s,
                               n_samples, truncated, closure)
    s0 = sbar[..., 0, :]
    lam = torch.where(torch.isfinite(s0), torch.clamp_min(s0, 0.0), 0.0)
    m = sbar / torch.clamp_min(s0, 1e-12)[..., None, :]       # m[0] == 1

    valid, safe_scale, safe_s, w_of, partial = _lognorm_w_machinery(
        beam_e, e_loss, scale, s)
    zero = torch.zeros_like(safe_s)
    if truncated:
        w_max = w_of(0.0)
        norm = partial(0, zero, w_max)
        norm = torch.where(valid & (norm > 0), norm, 1.0)
        p0_below = partial(0, w_of(grid.e0_lo), w_max)
        p1_below = partial(1, w_of(grid.e0_lo), w_max)
    else:
        norm = torch.ones_like(safe_s)
        p0_below = partial(0, w_of(grid.e0_lo), None)
        p1_below = partial(1, w_of(grid.e0_lo), None)
    p0_above = partial(0, zero, w_of(grid.e0_hi))
    p1_above = partial(1, zero, w_of(grid.e0_hi))

    def cond_mean_e0(p0, p1):
        return torch.where(p0 > 1e-30,
                           beam_e - e_loss
                           - safe_scale * p1 / torch.clamp_min(p0, 1e-30),
                           0.0)

    lam_below = torch.where(valid, n_samples * p0_below / norm, 0.0)
    lam_above = torch.where(valid, n_samples * p0_above / norm, 0.0)
    lam_all = torch.cat([lam, lam_below[..., None], lam_above[..., None]],
                        dim=-1)
    return CountsRates(lam_all, m, cond_mean_e0(p0_below, p1_below),
                       cond_mean_e0(p0_above, p1_above),
                       expected_e0_mean(beam_e, e_loss, scale, s, truncated))


def moments_from_counts(grid: E0Grid, counts: torch.Tensor,
                        rates: CountsRates):
    """Part 3 of the counts estimator, deterministic: Poisson cell counts
    (..., F+2) -> (moments (..., 4, F), e0_mean (...)).

    S_k[f] = count_f * E[t^k | cell f]; the e0 sample mean averages the
    cells' conditional means over all draws, overflow cells included.
    ``rates`` broadcasts against ``counts`` (e.g. one rate set per walker,
    counts per walker and run).
    """
    f = grid.n_fine
    cells = counts[..., :f]
    moments = cells[..., None, :] * torch.where(
        rates.lam[..., None, :f] > 0, rates.m, 0.0)
    cell_mean_e0 = grid.t_ref + grid.t_scale * rates.m[..., 1, :]
    e0_sum = (torch.sum(cells * cell_mean_e0, dim=-1)
              + counts[..., f] * rates.mean_below
              + counts[..., f + 1] * rates.mean_above)
    total = torch.sum(counts, dim=-1)
    e0_mean = torch.where(total > 0, e0_sum / torch.clamp_min(total, 1.0),
                          rates.e0_mean_expected)
    return moments, e0_mean


class _ExpectedGrid(torch.autograd.Function):
    """The closed-form grid, ``contract(expected_moments(...))``, and the
    e0 mean, with a float64 backward: the forward is the float32
    computation as it is, the backward differentiates the same function
    recomputed in float64 (the same float32 inputs and buffers, widened).
    The grid is a cubic reconstruction whose four channel rows cancel, and
    so does its derivative: float32 autograd of this stage leaves the
    log-prob's gradient a median 1.6e-3 from float64 on oneBD's preset,
    this backward 9e-5 (``perf/gradient_precision.py``)."""

    @staticmethod
    def forward(ctx, grid, beam_e, e_loss, scale, s, n_samples, truncated,
                closure):
        moments, e0_mean = expected_moments(grid, beam_e, e_loss, scale, s,
                                            n_samples, truncated, closure)
        ctx.save_for_backward(beam_e, e_loss, scale, s)
        ctx.args = (grid, n_samples, truncated, closure)
        return contract(grid, moments), e0_mean

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_grid, g_mean):
        grid, n_samples, truncated, closure = ctx.args
        with torch.enable_grad():
            params = [t.detach().double().requires_grad_(True)
                      for t in ctx.saved_tensors]
            moments, e0_mean = expected_moments(
                grid.float64(), *params, n_samples, truncated, closure)
            out = contract(grid.float64(), moments)
            grads = torch.autograd.grad(
                (out, e0_mean), params, (g_grid.double(), g_mean.double()),
                allow_unused=True)
        grads = [None if g is None or not need else g.to(t.dtype)
                 for g, t, need in zip(grads, ctx.saved_tensors,
                                       ctx.needs_input_grad[1:5])]
        return (None, *grads, None, None, None)


def expected_grid(grid: E0Grid, beam_e, e_loss, scale, s, n_samples: float,
                  truncated: bool, closure: str = "exact"):
    """The closed-form estimator's grid and e0 mean: parameters (...,) ->
    ((..., M, Be), (...,)), :func:`expected_moments` contracted with the A
    operator.  Where a parameter needs a gradient, the backward runs in
    float64 (:class:`_ExpectedGrid`); the values are the float32 ones
    either way."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (beam_e, e_loss, scale, s)):
        return _ExpectedGrid.apply(grid, beam_e, e_loss, scale, s,
                                   n_samples, truncated, closure)
    moments, e0_mean = expected_moments(grid, beam_e, e_loss, scale, s,
                                        n_samples, truncated, closure)
    return contract(grid, moments), e0_mean


def expected_e0_mean(beam_e, e_loss, scale, s, truncated: bool):
    """Closed-form mean of the beam-energy draw distribution."""
    valid = (scale > 0.0) & (s > 0.0)
    safe_scale = torch.where(scale > 0.0, scale, 1.0)
    safe_s = torch.where(s > 0.0, s, 1.0)
    if truncated:
        w_max = torch.clamp_min((beam_e - e_loss) / safe_scale, 1e-30)
        zmax = torch.log(w_max) / safe_s
        norm = ndtr(zmax)
        norm = torch.where(valid & (norm > 0), norm, 1.0)
        mean_w = (torch.exp(0.5 * safe_s * safe_s)
                  * ndtr(zmax - safe_s)) / norm
    else:
        mean_w = torch.exp(0.5 * safe_s * safe_s)
    return beam_e - e_loss - safe_scale * mean_w
