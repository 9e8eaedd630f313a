"""Posterior-level parity of the port against the JAX package, at a small
size on the CPU (2 runs, 8k draws, F = 128, 16 walkers, 16 thetas x 8
repeats): the two protocols of ``mcmctoffitting_tpu_torch/utils/parity.py``
against the JAX system's own formulas, the JAX package's side
(``perf/parity_reference.py``) against the port's
(``perf/posterior_parity.py --device cpu``), and the gates' teeth: the
same comparison at thetas shifted in beamE must fail."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.utils.diagnostics import \
    integrated_autocorr_time as jax_iat
from mcmctoffitting_tpu_torch.utils import parity

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_runs=2, n_draws=8000, fine_grid=128, walkers=16, burnin=100,
             max_burnin=400, main=100, block=20, min_ess=0.0, n_thetas=16,
             repeats=8)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  REPO / "perf" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _ar1_chain(rng, s, w, rho, mean=0.0, sd=1.0):
    x = np.empty((s, w))
    x[0] = rng.standard_normal(w)
    for i in range(1, s):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho ** 2) * rng.standard_normal(w)
    return mean + sd * x


def _tool_median_se(walker_chain):
    """``tools/reference_posterior_parity.py::_median_se`` on the JAX
    package's estimator."""
    s, w = walker_chain.shape
    tau = float(jax_iat(walker_chain[:, :, None]).max())
    ess = s * w / max(tau, 1.0)
    q = np.percentile(walker_chain.reshape(-1), [16, 84])
    sigma = 0.5 * (q[1] - q[0])
    return 1.2533 * sigma / np.sqrt(max(ess, 1.0)), ess


def test_median_se_is_the_tools():
    rng = np.random.default_rng(0)
    for rho in (0.0, 0.5, 0.9):
        chain = _ar1_chain(rng, 300, 16, rho, mean=3.0, sd=2.0)
        assert parity.median_se(chain) == pytest.approx(
            _tool_median_se(chain), rel=1e-12)


def test_dz_table_is_the_tools_report():
    """dz and z_se as the tool's ``report`` computes them, on two synthetic
    chains; a shift of half a sigma is a REVIEW, none a PASS."""
    rng = np.random.default_rng(1)
    names = ["a", "b"]
    ref = np.stack([_ar1_chain(rng, 400, 32, 0.8, 1.0, 2.0),
                    _ar1_chain(rng, 400, 32, 0.6, -5.0, 0.5)], -1)
    port = np.stack([_ar1_chain(rng, 400, 32, 0.8, 1.0, 2.0),
                     _ar1_chain(rng, 400, 32, 0.6, -5.0, 0.5)], -1)
    table = parity.dz_table(parity.chain_summary(ref, names), port, names)
    for d, row in enumerate(table["rows"]):
        rq = np.percentile(ref[:, :, d].reshape(-1), [16, 50, 84])
        oq = np.percentile(port[:, :, d].reshape(-1), [16, 50, 84])
        pooled = np.sqrt(0.5 * ((0.5 * (rq[2] - rq[0])) ** 2
                                + (0.5 * (oq[2] - oq[0])) ** 2))
        se_r, ess_r = _tool_median_se(ref[:, :, d])
        se_o, ess_o = _tool_median_se(port[:, :, d])
        assert row["dz"] == pytest.approx((oq[1] - rq[1]) / pooled,
                                          rel=1e-9)
        assert row["z_se"] == pytest.approx(
            (oq[1] - rq[1]) / np.sqrt(se_r ** 2 + se_o ** 2), rel=1e-9)
        assert row["ref_ess"] == pytest.approx(ess_r)
        assert row["port_ess"] == pytest.approx(ess_o)
    assert table["verdict"] == "PASS", parity.format_dz(table)
    port[:, :, 1] += 0.25        # half a posterior sigma of 'b'
    shifted = parity.dz_table(parity.chain_summary(ref, names), port, names)
    assert shifted["verdict"] == "REVIEW"
    assert shifted["worst_dz"] == pytest.approx(0.5, abs=0.1)


def test_between_chain_ess_holds_on_short_chains():
    """256 independent AR(1) chains of 50 steps at rho = 0.9 (tau = 19):
    the spread of the chains' means gives ESS ~ C S / tau = 674 within
    its sampling error, where the autocorrelation estimator's window
    cuts tau off and reports more."""
    rng = np.random.default_rng(3)
    rho, s, c = 0.9, 50, 256
    chain = np.stack([_ar1_chain(rng, s, c, rho), _ar1_chain(rng, s, c, 0.0)],
                     -1)
    # the exact ESS of a 50-step mean from a stationary AR(1) start
    lags = np.arange(1, s)
    tau_s = 1 + 2 * np.sum((1 - lags / s) * rho ** lags)
    ess = parity.between_chain_ess(chain)
    assert ess[0] == pytest.approx(c * s / tau_s, rel=0.3)
    assert ess[1] == pytest.approx(c * s, rel=0.3)
    assert parity.median_se(chain[:, :, 0])[1] > 1.3 * ess[0]


def test_density_gates_on_synthetic_tables():
    """Equal laws pass both gates; an offset that grows with theta by
    three standard errors at most, far below the 1-nat floor, passes the
    tool's spread rule and fails the chi-square gate."""
    rng = np.random.default_rng(2)
    n, r = 48, 16
    thetas = rng.standard_normal((n, 2))
    sd = np.full(n, 1.3)

    def means(offset):
        return (-600.0 + offset + sd * rng.standard_normal((r, n))
                .mean(0))

    same = parity.density_parity(means(0.0), sd, means(0.0), sd, r, thetas,
                                 ["x", "y"])
    assert same["verdict"] == "PASS", same
    se = np.sqrt(2 * sd ** 2 / r)
    tilted = parity.density_parity(means(0.0), sd,
                                   means(3 * se * thetas[:, 0]), sd, r,
                                   thetas, ["x", "y"])
    assert tilted["spread_verdict"] == "PASS"
    assert tilted["chi2_verdict"] == "REVIEW", tilted
    assert tilted["correlations"]["x"] > 0.8


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX package's references of simult_counts and simult_expected
    at the small size, made in process by perf/parity_reference.py
    ('expected' at simult_counts' thetas: one JAX chain instead of two)."""
    ref_mod = _load("parity_reference")
    out = tmp_path_factory.mktemp("parity")
    sizes = ref_mod.Sizes(**SMALL)
    meta, arrays = ref_mod.reference_case("simult_counts", sizes,
                                          log=lambda *a: None)
    ref_mod.write_case(meta, arrays, out)
    meta_e, arrays_e = ref_mod.reference_case(
        "simult_expected", sizes, thetas=arrays["thetas"],
        log=lambda *a: None)
    meta_e["chain"] = meta["chain"]     # whose thetas these are
    ref_mod.write_case(meta_e, arrays_e, out)
    return out


def test_references_hold_the_case(refs):
    meta = json.loads((refs / "simult_counts.json").read_text())
    assert meta["n_runs"] == 2 and meta["repeats"] == 8
    assert meta["spec_fields"]["e0_grid_fine"] == 128
    assert meta["chain"]["walkers"] == 16
    with np.load(refs / "simult_counts.npz") as z:
        assert z["thetas"].shape == (16, 6)
        assert np.all(np.isfinite(z["lp_mean"]))
        assert np.all(z["lp_sd"] > 0)
    with np.load(refs / "simult_expected.npz") as z:
        assert z["grad"].shape == (16, 6)


@pytest.fixture(scope="module")
def port_script():
    return _load("posterior_parity")


@pytest.mark.parametrize("case", ["simult_counts", "simult_expected"])
def test_port_passes_against_the_jax_package(refs, port_script, case):
    torch.manual_seed(0)
    rc = port_script.main([case, "--device", "cpu", "--ref-dir", str(refs),
                           "--no-chain"])
    result = json.loads((refs / f"{case}_port.json").read_text())
    assert rc == 0, result["density"]
    assert result["verdict"] == "PASS"
    assert result["device"] == "cpu"
    if case == "simult_expected":
        assert result["density"]["grad_verdict"] == "PASS"


def test_counts_gate_catches_a_beam_shift(refs, port_script):
    """simult_counts at thetas shifted by 0.25 posterior sigma of beamE
    (towards the middle of the box; beamE's posterior is as wide as a
    third of its box, so 3 sigma would leave it) against the same JAX
    values: the chi-square gate catches it.  The tool's spread rule alone
    does not: its 5 x noise is ~95 nats at 8k draws (the per-evaluation
    sd is 10-60 nats), the shift's spread ~85."""
    ref = parity.load_reference(refs / "simult_counts.npz")
    problem = parity.build_problem(ref.meta, "cpu")
    shifted = parity.shifted_thetas(ref, problem, 0.25)
    result = port_script.run_case("simult_counts", "cpu", ref_dir=refs,
                                  chain=False, thetas=shifted)
    assert result["density"]["chi2_verdict"] == "REVIEW", result["density"]
    assert result["verdict"] == "REVIEW"


def test_expected_gate_catches_a_quarter_sigma_shift(refs, port_script):
    """simult_expected at thetas shifted by 0.25 posterior sigma of beamE:
    the deterministic spread tolerance catches it."""
    ref = parity.load_reference(refs / "simult_expected.npz")
    problem = parity.build_problem(ref.meta, "cpu")
    shifted = parity.shifted_thetas(ref, problem, 0.25)
    result = port_script.run_case("simult_expected", "cpu", ref_dir=refs,
                                  chain=False, thetas=shifted)
    dens = result["density"]
    assert dens["n_finite"] == dens["n_thetas"]
    assert dens["spread_verdict"] == "REVIEW", dens
    assert dens["spread_nats"] > 4 * parity.EXPECTED_SPREAD_NATS


def test_expected_gradient_gate_catches_a_scaled_backward(refs, port_script,
                                                          monkeypatch):
    """simult_expected with K2's gradient 5% too large and its value
    unchanged (the fault a wrong backward would make): the per-theta
    tolerance lets it through, the median gate catches it."""
    from mcmctoffitting_tpu_torch.ops import cuda_tof

    plain = cuda_tof.tof_hist_segments_plain

    def scaled(*args):
        out = plain(*args)
        return out * 1.05 - (0.05 * out).detach()

    monkeypatch.setattr(cuda_tof, "tof_hist_segments_plain", scaled)
    result = port_script.run_case("simult_expected", "cpu", ref_dir=refs,
                                  chain=False)
    dens = result["density"]
    assert dens["spread_verdict"] == "PASS", dens
    assert dens["grad_rel_l2_max"] < parity.EXPECTED_GRAD_REL_L2
    assert dens["grad_rel_l2_median"] > parity.EXPECTED_GRAD_REL_L2_MEDIAN
    assert dens["grad_verdict"] == "REVIEW", dens["grad_rel_l2_median"]
