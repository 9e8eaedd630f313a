"""The port's host-built tables vs the JAX package's: the static tables
the forward reads (stopping table, splines, the e0-grid A operator, timing
taps, the zero-degree segment tables) and the kinematics they come from.

Both packages build them with the same f64 numpy arithmetic, so the
tables must be bitwise equal; the zero-degree tables are float32 in both
(XLA's and numpy's exp and sqrt may differ by an ulp), and the exGaussian
taps are compared at rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.models.forward import _zero_degree_spread
from mcmctoffitting_tpu.ops import e0grid as je0
from mcmctoffitting_tpu.ops import interp as jinterp
from mcmctoffitting_tpu.ops import kinematics as jkin
from mcmctoffitting_tpu.ops import timing as jtiming
from mcmctoffitting_tpu.ops import xs as jxs
from mcmctoffitting_tpu.config import SIMULTFIT_ED_BINNING, SIMULTFIT_X_BINNING
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import e0grid as te0
from mcmctoffitting_tpu_torch.ops import interp as tinterp
from mcmctoffitting_tpu_torch.ops import kinematics as tkin
from mcmctoffitting_tpu_torch.ops import timing as ttiming
from mcmctoffitting_tpu_torch.ops import xs as txs

torch.set_num_threads(1)


def test_stopping_table_bitwise():
    want = jsimult._build_table(8.565e-5)
    got = tsimult._build_table(8.565e-5)
    for field in ("e0_grid", "x_centers", "table", "coeffs"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_spline_coeffs_bitwise():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.uniform(0.5, 2.0, 17))
    y = rng.standard_normal((17, 3))
    np.testing.assert_array_equal(tinterp.cubic_spline_coeffs(x, y),
                                  jinterp.cubic_spline_coeffs(x, y))
    np.testing.assert_array_equal(txs.ddn_xs.coeffs, jxs.ddn_xs.coeffs)
    np.testing.assert_array_equal(txs.ddn_xs_uniform.coeffs,
                                  jxs.ddn_xs_uniform.coeffs)


@pytest.mark.parametrize("spline", ["ddn_xs", "ddn_xs_uniform"])
def test_spline_eval_np_bitwise(spline):
    e = np.linspace(0.0, 12000.0, 4001)     # includes both clamp regions
    np.testing.assert_array_equal(getattr(txs, spline).eval_np(e),
                                  getattr(jxs, spline).eval_np(e))


@pytest.mark.parametrize("n_fine", [64, 512])
def test_a_matrix_bitwise(n_fine):
    want = je0.build_e0_grid_table(jsimult._build_table(8.565e-5),
                                   SIMULTFIT_ED_BINNING, jxs.ddn_xs_uniform,
                                   n_fine=n_fine)
    got = te0.build_e0_grid_table(tsimult._build_table(8.565e-5),
                                  SIMULTFIT_ED_BINNING, txs.ddn_xs_uniform,
                                  n_fine=n_fine)
    np.testing.assert_array_equal(got.a_matrix, want.a_matrix)
    for field in ("e0_lo", "e0_hi", "n_fine", "t_ref", "t_scale", "n_x",
                  "n_ed", "ed_lo", "ed_hi"):
        assert getattr(got, field) == getattr(want, field), field


def test_zero_degree_tables():
    spec = jsimult.default_spec(8000, sampling="counts", fine_grid=64)
    zt_j, zw_j = (np.asarray(a) for a in _zero_degree_spread(spec))
    tables = tforward.forward_tables(
        tsimult.default_spec(8000, sampling="counts", fine_grid=64))
    assert tables.zt.shape == zt_j.shape == (SIMULTFIT_ED_BINNING.n, 10)
    np.testing.assert_allclose(tables.zt, zt_j, rtol=1e-6)
    np.testing.assert_allclose(tables.zw, zw_j, rtol=1e-6)


def test_exgaussian_taps():
    got = ttiming.ExGaussianTiming().kernel
    want = jtiming.ExGaussianTiming().kernel
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_kinematics():
    e_d = np.linspace(200.0, 1300.0, 257)
    np.testing.assert_array_equal(tkin.dd_neutron_energy_np(e_d),
                                  jkin.dd_neutron_energy_np(e_d))
    e32 = e_d.astype(np.float32)
    np.testing.assert_allclose(
        tkin.dd_neutron_energy(torch.as_tensor(e32)).numpy(),
        np.asarray(jkin.dd_neutron_energy(jnp.asarray(e32))), rtol=1e-6)
    dist = np.linspace(0.1, 500.0, 257).astype(np.float32)
    np.testing.assert_allclose(
        tkin.tof(1.8756e6, torch.as_tensor(e32), torch.as_tensor(dist)),
        np.asarray(jkin.tof(1.8756e6, jnp.asarray(e32), jnp.asarray(dist))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tkin.tof_np(939565.0, e_d, dist.astype(np.float64)),
        np.asarray(jkin.tof(939565.0, jnp.asarray(e32), jnp.asarray(dist))),
        rtol=1e-6)


def test_tables_from_numpy_match_own_tables():
    """The converter carries the JAX package's arrays into the same
    buffers the port's own tables fill."""
    jspec = jsimult.default_spec(8000, sampling="counts", fine_grid=64)
    tab = jspec.e0_grid_table
    zt, zw = _zero_degree_spread(jspec)
    converted = tforward.forward_tables_from_numpy(
        a_matrix=tab.a_matrix, e0_lo=tab.e0_lo, e0_hi=tab.e0_hi,
        n_fine=tab.n_fine, t_ref=tab.t_ref, t_scale=tab.t_scale,
        n_x=tab.n_x, n_ed=tab.n_ed, ed_lo=tab.ed_lo, ed_hi=tab.ed_hi,
        timing_kernel=jtiming.ExGaussianTiming().kernel,
        zt=np.asarray(zt), zw=np.asarray(zw))
    tspec = tsimult.default_spec(8000, sampling="counts", fine_grid=64)
    problem = tsimult.SimultFitProblem(tspec, device="cpu")
    own = tforward.TofForward(tspec, problem.standoffs, problem.windows,
                              device="cpu")
    conv = tforward.TofForward(tspec, problem.standoffs, problem.windows,
                               device="cpu", tables=converted)
    np.testing.assert_array_equal(conv.e0grid.a_matrix.numpy(),
                                  own.e0grid.a_matrix.numpy())
    np.testing.assert_array_equal(conv.timing.numpy(), own.timing.numpy())
    np.testing.assert_allclose(conv.zt.numpy(), own.zt.numpy(), rtol=1e-6)
    np.testing.assert_allclose(conv.zw.numpy(), own.zw.numpy(), rtol=1e-6)
    assert SIMULTFIT_X_BINNING.n == own.x.shape[0]
