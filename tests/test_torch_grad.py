"""Gradients of the port (mcmctoffitting_tpu_torch) against the JAX
package, on the CPU at a small size (<= 3 runs, F = 64, <= 8 chains).

(a) Kernel K2's VJP: ``jax.vjp`` of the JAX package's
    ``make_tof_hist_segments`` (interpret mode; its ``_fn_bwd``) against
    ``torch.autograd.grad`` through the port's ``tof_hist_segments``, to
    1e-6 of each cell's sum_k |zw| max|gbar|; the port's explicit gather
    against its autograd; linearity, exactly: the backward of a one-hot
    cotangent is the forward of one-hot draws.
(b) The log-prob's gradient of both flagships in the differentiable
    configuration ('expected', corrected likelihood, no rint; oneBD with the
    background's expectation): ``jax.grad`` against ``torch.autograd.grad``
    of the summed batch, relative L2 <= 1e-3 per chain (both float32; the
    closed-form moments cancel across the A operator's channel rows), and
    the beamE-eLoss degeneracy signature of ``tests/test_nuts.py``.
(c) ``BoxLogitTransform``, ``dual_averaging_warmup`` and the leapfrog
    against the JAX package's on the same inputs, float32 tolerances;
    ``adam_map`` against the JAX one (skipped without optax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.constants import TofWindow
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.ops.pallas_tof import make_tof_hist_segments
from mcmctoffitting_tpu.sampler import hmc as jhmc
from mcmctoffitting_tpu.sampler._adapt import (
    dual_averaging_warmup as j_dual_averaging)
from mcmctoffitting_tpu.sampler.transforms import (
    BoxLogitTransform as JBoxLogit)
from mcmctoffitting_tpu_torch.models import onebd as tonebd
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import e0grid as te0grid
from mcmctoffitting_tpu_torch.ops.cuda_tof import (
    tof_hist_segments, tof_hist_segments_backward,
    tof_hist_segments_bwd_plain)
from mcmctoffitting_tpu_torch.ops.histogram import window_constants
from mcmctoffitting_tpu_torch.sampler import hmc as thmc
from mcmctoffitting_tpu_torch.sampler._adapt import (
    LogpAndGrad, dual_averaging_warmup)
from mcmctoffitting_tpu_torch.sampler.transforms import BoxLogitTransform
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io

torch.set_num_threads(1)

WINDOWS = (TofWindow(175.0, 225.0, 50), TofWindow(130.0, 175.0, 45))
M, BE, K = 5, 12, 4
N_FINE = 64


def _lattice(seed, w_batch=2, k=K, dyadic=False):
    rng = np.random.default_rng(seed)
    shape = (w_batch, len(WINDOWS), M, BE)
    base = rng.uniform(120.0, 270.0, shape).astype(np.float32)
    draws = rng.uniform(0.0, 50.0, shape).astype(np.float32)
    zt = rng.uniform(-6.0, 6.0, (BE, k)).astype(np.float32)
    zw = (rng.integers(0, 9, (BE, k)) / 8.0 if dyadic
          else rng.uniform(0.0, 1.0, (BE, k))).astype(np.float32)
    gbar = rng.standard_normal((w_batch, len(WINDOWS), 50)).astype(
        np.float32)
    return base, draws, zt, zw, gbar


def _port_vjp(base, draws, zt, zw, gbar):
    win = window_constants(WINDOWS, device="cpu")
    d = torch.tensor(draws, requires_grad=True)
    out = tof_hist_segments(torch.as_tensor(base), d, torch.as_tensor(zt),
                            torch.as_tensor(zw), win)
    grad, = torch.autograd.grad(out, d, torch.as_tensor(gbar))
    return grad.numpy()


# --- (a) K2's VJP ------------------------------------------------------------

def test_k2_vjp_matches_jax_custom_vjp():
    """The port's autograd through the plain histogram against the JAX
    package's custom VJP (``_fn_bwd``: the gather of gbar at each sample's
    bin), walker by walker; zero for base_tof, zt and zw on both sides."""
    base, draws, zt, zw, gbar = _lattice(0)
    fn = make_tof_hist_segments(WINDOWS, M, BE, K, interpret=True)
    got = _port_vjp(base, draws, zt, zw, gbar)
    bound = 1e-6 * np.abs(zw).sum(1).max() * np.abs(gbar).max()
    for w in range(base.shape[0]):
        _, vjp = jax.vjp(fn, jnp.asarray(base[w]), jnp.asarray(draws[w]),
                         jnp.asarray(zt), jnp.asarray(zw))
        g_base, g_draws, g_zt, g_zw = (np.asarray(g) for g in
                                       vjp(jnp.asarray(gbar[w])))
        assert np.abs(got[w] - g_draws).max() <= bound
        assert not g_base.any() and not g_zt.any() and not g_zw.any()
    # and something reached the gradient: about a third of the cells have
    # samples in their run's window
    assert np.count_nonzero(got) > 0.2 * got.size


def test_k2_explicit_gather_equals_autograd():
    """``tof_hist_segments_bwd_plain`` (what the kernel is held against on
    the card) is the autograd of the plain version, and in float64 within
    the float32 tolerance of it; ``tof_hist_segments_backward`` on the CPU
    takes the plain gather."""
    base, draws, zt, zw, gbar = _lattice(1)
    want = _port_vjp(base, draws, zt, zw, gbar)
    win = window_constants(WINDOWS, device="cpu")
    args = (torch.as_tensor(gbar), torch.as_tensor(base),
            torch.as_tensor(zt), torch.as_tensor(zw), win)
    np.testing.assert_array_equal(tof_hist_segments_bwd_plain(*args).numpy(),
                                  want)
    np.testing.assert_array_equal(tof_hist_segments_backward(*args).numpy(),
                                  want)
    g64 = tof_hist_segments_bwd_plain(*args, torch.float64).numpy()
    bound = 1e-6 * np.abs(zw).sum(1).max() * np.abs(gbar).max()
    assert np.abs(want - g64).max() <= bound


def test_k2_backward_is_the_forward_transposed():
    """Linearity, exactly (dyadic segment weights, so every sum is exact):
    the backward of the one-hot cotangent of bin j at cell c equals the
    forward's bin j of the one-hot draws at cell c, over every cell and
    bin, with the np.histogram edges among the samples."""
    base, _, zt, zw, _ = _lattice(2, w_batch=1, dyadic=True)
    base[0, 1, 0, :3] = [WINDOWS[1].hi, WINDOWS[1].lo, np.nan]
    zt[:3] = 0.0
    win = window_constants(WINDOWS, device="cpu")
    n_cells, n_pad = M * BE, win.n_pad
    b = torch.as_tensor(base).expand(n_cells, -1, -1, -1).contiguous()
    one_hot = torch.eye(n_cells).reshape(n_cells, 1, M, BE).expand(
        -1, len(WINDOWS), -1, -1).contiguous()
    fwd = tof_hist_segments(b, one_hot, torch.as_tensor(zt),
                            torch.as_tensor(zw), win)     # (cells, R, bins)
    bwd = tof_hist_segments_backward(
        torch.eye(n_pad).reshape(n_pad, 1, n_pad).expand(
            -1, len(WINDOWS), -1).contiguous(),
        torch.as_tensor(base).expand(n_pad, -1, -1, -1).contiguous(),
        torch.as_tensor(zt), torch.as_tensor(zw), win)   # (bins, R, M, Be)
    np.testing.assert_array_equal(
        fwd.numpy().transpose(2, 1, 0),
        bwd.numpy().reshape(n_pad, len(WINDOWS), n_cells))
    assert fwd.numpy()[:, 1, WINDOWS[1].n_bins - 1].any()


def test_k2_backward_refuses_a_wrong_cotangent():
    base, _, zt, zw, _ = _lattice(3)
    win = window_constants(WINDOWS, device="cpu")
    with pytest.raises(ValueError, match="cotangent"):
        tof_hist_segments_backward(torch.zeros(2, 2, 49),
                                   torch.as_tensor(base),
                                   torch.as_tensor(zt), torch.as_tensor(zw),
                                   win)


# --- (b) the flagships' log-prob gradients -----------------------------------

def _problems(model):
    kw = dict(fine_grid=N_FINE, sampling="expected")
    if model == "simult":
        jspec = jsimult.default_spec(200_000, **kw)
        tspec = tsimult.default_spec(200_000, **kw)
        jprob = jsimult.SimultFitProblem(
            dataclasses.replace(jspec, rint_draws=False), n_runs=2,
            likelihood="poisson")
        tprob = tsimult.SimultFitProblem(
            dataclasses.replace(tspec, rint_draws=False), n_runs=2,
            likelihood="poisson", device="cpu")
        truth = np.concatenate([tsimult.GUESS_SHARED, [5e4, 5e4]])
    else:
        jspec = jonebd.default_spec(200_000, **kw)
        tspec = tonebd.default_spec(200_000, **kw)
        jprob = jonebd.OneBDProblem(
            dataclasses.replace(jspec, rint_draws=False, bg_mode="expected"),
            n_runs=3, likelihood="poisson")
        tprob = tonebd.OneBDProblem(
            dataclasses.replace(tspec, rint_draws=False, bg_mode="expected"),
            n_runs=3, likelihood="poisson", device="cpu")
        truth = tdata_io.ONEBD_TRUTH
    observed = tdata_io.synthesize_observed(0, tprob, truth)
    return jprob, tprob, truth.astype(np.float32), observed


def _grads(jprob, tprob, observed, thetas):
    jlogp = jprob.make_log_prob_fn(observed)
    key = jax.random.PRNGKey(0)
    g_j = np.asarray(jax.jit(jax.vmap(jax.grad(lambda t: jlogp(t, key))))(
        jnp.asarray(thetas)))
    x = torch.tensor(thetas, requires_grad=True)
    lp = tprob.make_log_prob_fn(observed)(x, torch.Generator().manual_seed(0))
    g_t, = torch.autograd.grad(lp.sum(), x)
    return g_j, g_t.numpy()


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_log_prob_gradient_matches_jax_grad(model):
    """Per chain, the gradient of the summed batch log-prob equals
    ``jax.grad`` of the JAX problem's log-prob to 1e-3 relative L2, at
    eight points around the truth (1% spread) where the gradient is far
    from zero."""
    jprob, tprob, truth, observed = _problems(model)
    rng = np.random.default_rng(4)
    thetas = (truth * (1.0 + 0.01 * rng.standard_normal(
        (8, truth.size)))).astype(np.float32)
    g_j, g_t = _grads(jprob, tprob, observed, thetas)
    assert np.isfinite(g_t).all() and np.isfinite(g_j).all()
    rel = np.linalg.norm(g_t - g_j, axis=1) / np.linalg.norm(g_j, axis=1)
    assert np.all(rel <= 1e-3), rel


def test_log_prob_gradient_degeneracy_signature():
    """At the truth, in the scaled coordinates of ``tests/test_nuts.py``:
    every shape parameter carries gradient and the beamE-eLoss
    degeneracy shows as near-opposite components, on both sides."""
    jprob, tprob, truth, observed = _problems("simult")
    scales = np.asarray([30.0, 30.0, 3.0, 0.01, 300.0, 300.0], np.float32)
    g_j, g_t = _grads(jprob, tprob, observed, truth[None])
    for g in (g_j[0] * scales, g_t[0] * scales):
        assert (np.abs(g[:4]) > 0.05).all(), g
        assert abs(g[0] + g[1]) < 0.2 * (abs(g[0]) + abs(g[1]) + 1e-6)


def test_relu_split_value_and_tie_gradient():
    """``relu_split`` is max(x, 0) bit for bit, with ``jnp.maximum``'s
    half gradient at the tie."""
    x = torch.tensor([-2.0, -0.0, 0.0, 1e-30, 3.5, float("nan")],
                     requires_grad=True)
    y = te0grid.relu_split(x)
    want = torch.clamp_min(x.detach(), 0.0)
    assert torch.equal(y.detach()[:5], want[:5]) and torch.isnan(y[5])
    g, = torch.autograd.grad(y[:5].sum(), x)
    g_j = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0)))(
        jnp.asarray(x.detach().numpy()[:5]))
    np.testing.assert_array_equal(g.numpy()[:5], np.asarray(g_j))


# --- (c) transform, adaptation, leapfrog, Adam -------------------------------

LO = np.array([1825.0, 600.0, 0.0], np.float32)
HI = np.array([1925.0, 1000.0, 1.0e6], np.float32)


def test_box_logit_transform_matches_jax():
    rng = np.random.default_rng(5)
    u = rng.normal(0.0, 3.0, (6, 3)).astype(np.float32)
    jt, tt = JBoxLogit(LO, HI), BoxLogitTransform(LO, HI, device="cpu")
    tu = torch.as_tensor(u)
    np.testing.assert_allclose(tt.to_theta(tu).numpy(),
                               np.asarray(jt.to_theta(jnp.asarray(u))),
                               rtol=1e-6)
    np.testing.assert_allclose(tt.log_det_jacobian(tu).numpy(),
                               np.asarray(jt.log_det_jacobian(
                                   jnp.asarray(u))), rtol=1e-6, atol=1e-5)
    theta = np.array([[1878.4, 850.0, 5.0e4], [1825.0, 1000.0, 0.0],
                      [1830.0, 990.0, 9.9e5]], np.float32)   # faces too
    np.testing.assert_allclose(tt.to_u(theta).numpy(),
                               np.asarray(jt.to_u(jnp.asarray(theta))),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(tt.log_det_jacobian(tt.to_u(theta))).all()
    inside = theta[[0, 2]]     # a face comes back eps of the width inside
    np.testing.assert_allclose(tt.to_theta(tt.to_u(inside)).numpy(), inside,
                               rtol=2e-4)
    # the log-Jacobian's gradient, and the wrapped log-prob's
    x = tu.clone().requires_grad_(True)
    g_t, = torch.autograd.grad(tt.log_det_jacobian(x).sum(), x)
    g_j = jax.vmap(jax.grad(jt.log_det_jacobian))(jnp.asarray(u))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    mu = np.array([1870.0, 800.0, 3e5], np.float32)
    sig = np.array([10.0, 50.0, 1e5], np.float32)
    t_logp = tt.wrap_logp(lambda th: -0.5 * torch.sum(
        ((th - torch.as_tensor(mu)) / torch.as_tensor(sig)) ** 2, dim=-1))
    j_logp = jt.wrap_logp(lambda th: -0.5 * jnp.sum(((th - mu) / sig) ** 2))
    x = tu.clone().requires_grad_(True)
    g_t, = torch.autograd.grad(t_logp(x).sum(), x)
    g_j = jax.vmap(jax.grad(j_logp))(jnp.asarray(u))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        BoxLogitTransform([0.0, 1.0], [1.0, 1.0], device="cpu")


def test_dual_averaging_matches_jax_on_a_scripted_sequence():
    """The same acceptance statistics (per-chain vectors, NaN among them)
    give the same adapted step size; NaN counts as alpha = 0."""
    rng = np.random.default_rng(6)
    alphas = rng.uniform(0.2, 1.0, (40, 4)).astype(np.float32)
    alphas[3, 1] = np.nan
    alphas[10] = np.nan
    alphas[17, 2] = np.inf

    def j_step(state, eps, key):
        i = state
        return i + 1, jnp.asarray(alphas)[i]

    def t_step(state, eps):
        return state + 1, torch.as_tensor(alphas[state])

    _, eps_j = j_dual_averaging(jax.random.PRNGKey(0), jnp.int32(0), j_step,
                                40, 0.1, 0.8)
    n, eps_t = dual_averaging_warmup(0, t_step, 40, 0.1, 0.8, device="cpu")
    assert n == 40
    np.testing.assert_allclose(float(eps_t), float(eps_j), rtol=1e-5)
    # no warm-up: the initial step size, as the JAX package returns it
    _, eps0_j = j_dual_averaging(jax.random.PRNGKey(0), jnp.int32(0),
                                 j_step, 0, 0.1, 0.8)
    _, eps0 = dual_averaging_warmup(0, t_step, 0, 0.1, 0.8,
                                    device="cpu")
    np.testing.assert_allclose(float(eps0), float(eps0_j), rtol=1e-6)
    np.testing.assert_allclose(float(eps0), 0.1, rtol=1e-6)


def _target_np():
    prec = np.array([[2.0, 0.9, 0.0], [0.9, 1.5, -0.3], [0.0, -0.3, 0.7]],
                    np.float32)
    return prec


def test_leapfrog_matches_jax_on_the_same_momenta():
    """The deterministic core: the same positions, momenta and gradients
    after the trajectory (a correlated Gaussian with a quartic term), per
    chain lengths on the port's side against JAX's one length per call."""
    prec = _target_np()
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3)).astype(np.float32)
    p = rng.standard_normal((2, 3)).astype(np.float32)

    def j_logp(x):
        return -0.5 * x @ jnp.asarray(prec) @ x - 0.05 * jnp.sum(x ** 4)

    def t_logp(x):
        return (-0.5 * torch.einsum("ci,ij,cj->c", x, torch.as_tensor(prec),
                                    x) - 0.05 * torch.sum(x ** 4, dim=-1))

    j_vg = jax.vmap(jax.value_and_grad(j_logp))
    t_vg = LogpAndGrad(t_logp)
    lp0, g0 = t_vg(torch.as_tensor(q))
    lengths = (3, 7)
    q_t, p_t, g_t, lp_t = thmc._leapfrog(
        t_vg, torch.as_tensor(q), torch.as_tensor(p), g0, lp0, 0.15,
        torch.tensor(lengths), torch.ones(3))
    assert t_vg.calls == 1 + max(lengths)
    for c, n in enumerate(lengths):
        _, g0_j = j_vg(jnp.asarray(q[c:c + 1]))
        q_j, p_j, g_j = jhmc._leapfrog(
            j_vg, jnp.asarray(q[c:c + 1]), jnp.asarray(p[c:c + 1]), g0_j,
            0.15, 8, n, jnp.ones(3))
        for got, want in ((q_t, q_j), (p_t, p_j), (g_t, g_j)):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want)[0],
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lp_t[c].item(),
                                   float(j_vg(q_j)[0][0]), rtol=1e-5)
    # one length for all chains: the same as the per-chain call at that
    # length
    q_s, p_s, _, _ = thmc._leapfrog(t_vg, torch.as_tensor(q),
                                    torch.as_tensor(p), g0, lp0, 0.15, 7,
                                    torch.ones(3))
    assert torch.equal(q_s[1], q_t[1]) and torch.equal(p_s[1], p_t[1])


def test_adam_map_matches_jax():
    pytest.importorskip("optax")
    from mcmctoffitting_tpu.utils.optimize import adam_map as j_adam
    from mcmctoffitting_tpu_torch.utils.optimize import adam_map as t_adam
    c = np.array([1.0, -2.0, 0.5], np.float32)
    w = np.array([1.0, 4.0, 0.25], np.float32)
    x_j, loss_j = j_adam(lambda t, k: -jnp.sum(w * (t - c) ** 2),
                         np.zeros(3), steps=40, learning_rate=0.05)
    x_t, loss_t = t_adam(lambda t, g: -torch.sum(
        torch.as_tensor(w) * (t - torch.as_tensor(c)) ** 2), np.zeros(3),
        steps=40, learning_rate=0.05, device="cpu")
    np.testing.assert_allclose(x_t, x_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)


def test_minimize_nll_with_common_random_numbers():
    """SciPy on the host: every evaluation starts the generator from the
    same state, so a noisy log-prob is a deterministic objective; the
    bounded run lands on the optimum of a quadratic."""
    from mcmctoffitting_tpu_torch.utils.optimize import minimize_nll
    c = torch.tensor([1.0, -2.0, 0.5])

    def logp(theta, generator):
        noise = torch.rand((), generator=generator)
        return -torch.sum((theta - c) ** 2) - noise

    gen = torch.Generator().manual_seed(3)
    res = minimize_nll(logp, np.zeros(3), generator=gen, method="L-BFGS-B",
                       bounds=[(-5.0, 5.0)] * 3, device="cpu")
    np.testing.assert_allclose(res.x, c.numpy(), atol=2e-2)
    res = minimize_nll(logp, np.zeros(3), generator=gen,
                       method="Nelder-Mead", tol=1e-8, device="cpu")
    np.testing.assert_allclose(res.x, c.numpy(), atol=1e-3)


def _default_device_calls():
    """Each of the four optimiser and sampler helpers, called with its
    default device."""
    from mcmctoffitting_tpu_torch.utils.optimize import adam_map, minimize_nll

    def logp(theta, generator):
        return -torch.sum(theta ** 2)

    return {
        "minimize_nll": lambda: minimize_nll(logp, np.zeros(2), maxiter=2),
        "adam_map": lambda: adam_map(logp, np.zeros(2), steps=1),
        "BoxLogitTransform": lambda: BoxLogitTransform(LO, HI),
        "dual_averaging_warmup": lambda: dual_averaging_warmup(
            0, lambda i, eps: (i + 1, torch.ones(2)), 1, 0.1, 0.8),
    }


@pytest.mark.parametrize("name", ["minimize_nll", "adam_map",
                                  "BoxLogitTransform",
                                  "dual_averaging_warmup"])
def test_default_device_is_the_gpu(name, monkeypatch):
    """Called without a device, each runs on the GPU: without one it
    raises, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        _default_device_calls()[name]()



def test_expected_grid_values_float32_backward_float64():
    """``expected_grid`` gives the float32 grid and mean of
    ``contract(expected_moments(...))`` bit for bit, with or without a
    gradient, and differentiates in float64: its parameter gradient equals
    the float64 evaluation's but for its last rounding to float32, where
    plain float32 autograd is off by the cancellation of the cubic
    reconstruction's channel rows."""
    tspec = tsimult.default_spec(200_000, fine_grid=256, sampling="expected")
    tprob = tsimult.SimultFitProblem(tspec, n_runs=1, device="cpu")
    grid = tprob.forward.e0grid
    rng = np.random.default_rng(8)
    params = torch.tensor(np.c_[rng.uniform(1860, 1900, 6),
                                rng.uniform(800, 900, 6),
                                rng.uniform(150, 190, 6),
                                rng.uniform(0.4, 0.6, 6)], dtype=torch.float32)
    weights = torch.tensor(rng.standard_normal((6, 10, 50)),
                           dtype=torch.float32).double()
    args = (tspec.n_samples, tspec.truncated, tspec.moment_closure)

    def plain(g, p):
        m, mean = te0grid.expected_moments(g, *p.unbind(1), *args)
        return te0grid.contract(g, m), mean

    want_grid, want_mean = plain(grid, params)
    x = params.clone().requires_grad_(True)
    got_grid, got_mean = te0grid.expected_grid(grid, *x.unbind(1), *args)
    assert torch.equal(got_grid.detach(), want_grid)
    assert torch.equal(got_mean.detach(), want_mean)
    g, = torch.autograd.grad((got_grid * weights.float()).sum(), x)
    x64 = params.double().requires_grad_(True)
    g64, = torch.autograd.grad((plain(grid.float64(), x64)[0]
                                * weights).sum(), x64)
    x32 = params.clone().requires_grad_(True)
    g32, = torch.autograd.grad((plain(grid, x32)[0]
                                * weights.float()).sum(), x32)
    assert torch.allclose(g.double(), g64, rtol=1e-6, atol=0)
    assert (g.double() - g64).abs().max() < (g32.double() - g64).abs().max()
    assert grid.float64() is grid.float64()      # made once
    assert torch.equal(grid.float64().a_matrix, grid.a_matrix.double())
    assert "float64" not in dict(grid.named_modules())
