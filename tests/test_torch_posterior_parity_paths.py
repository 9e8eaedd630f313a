"""Posterior parity on the paths beyond the flagship counts fits, at a small
size on the CPU (2 runs, 8k draws, F = 128, 16 walkers, 16 thetas x 8
repeats; the simple family at 20k draws): the batch-median standard error
that gates z_se, mc 'exact' on rk4 (K3's path), the faithful likelihood
with its -inf shares, the simple family's v2 with its DE chain, and the
evidence of parallel tempering; each port side against the JAX package's
(``perf/parity_reference.py``), the gates' teeth and the chain gate's
reach, and HMC against the JAX package's HMC from the same start."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.utils import parity

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_runs=2, n_draws=8000, fine_grid=128, walkers=16, burnin=100,
             max_burnin=400, main=100, block=20, min_ess=0.0, n_thetas=16,
             repeats=8)
# the simple family's multinomial likelihood wants every bin filled: 20k
# draws a walker; from the CLI's start ball (0.01 wide) the ensemble
# needs 300 DE steps at 32 walkers to spread to its posterior, whose
# sigma sets the shifted thetas' step
SIMPLE = dict(SMALL, n_runs=None, n_draws=20_000, walkers=32, burnin=300,
              max_burnin=300, main=100, block=50, density_chunk=16)
# the analytic evidence case at a small size: 4 temperatures x 16
# walkers, 50 + 200 steps thinned by 2, 3 seeds a package
PT_SMALL = dict(parity.PT_CASES["pt_shifting_gaussian"], temps=4,
                walkers=16, burnin=50, steps=200, thin=2, seeds=3)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  REPO / "perf" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


# ---- the batch-median standard error ----------------------------------------

def _ar1(rng, n_rep, s, w, rho):
    x = np.empty((n_rep, s, w))
    x[:, 0] = rng.standard_normal((n_rep, w))
    noise = rng.standard_normal((n_rep, s, w)) * np.sqrt(1 - rho ** 2)
    for i in range(1, s):
        x[:, i] = rho * x[:, i - 1] + noise[:, i]
    return x


def _ensembles(rng, n_rep, s, w, rho, shared):
    """AR(1) walkers plus an AR(1) component that all walkers share (the
    ensemble's between-walker correlation), unit variance: (n, S, W)."""
    return (np.sqrt(shared) * _ar1(rng, n_rep, s, 1, rho)
            + np.sqrt(1 - shared) * _ar1(rng, n_rep, s, w, rho))


@pytest.mark.parametrize("taus, shared, swapped",
                         [(8, 0.5, False), (50, 0.5, False), (8, 0.0, True)])
def test_batch_median_se_covers_at_8_and_50_tau(taus, shared, swapped):
    """Two independent ensembles per replicate (32 walkers, tau = 20, half
    the variance shared by the walkers), 250 replicates: the medians'
    difference in the batch SE (z_se as the gate computes it) has sd
    within [0.8, 1.25] at 8 and 50 tau.  In the tool's ``median_se`` it
    is far wider (it counts the walkers as independent and its window
    needs 50 tau): above 1.25 at 8 tau, the fault of the oneBD chain.
    Also with the walkers shuffled among their slots at every step, as
    PT's swaps shuffle its cold rung: a slot alone reads tau ~1, the
    ensemble's median does not (sd 1.76 when the blocks followed the
    slots' tau)."""
    rng = np.random.default_rng(20 + taus + int(swapped))
    tau, n = 20.0, 250
    rho = (tau - 1) / (tau + 1)
    s = int(taus * tau)
    a = _ensembles(rng, n, s, 32, rho, shared)
    b = _ensembles(rng, n, s, 32, rho, shared)
    if swapped:
        for x in (a, b):
            x[:] = np.take_along_axis(
                x, np.argsort(rng.random(x.shape), axis=2), axis=2)
    z_new, z_tool = [], []
    for i in range(n):
        diff = np.median(b[i]) - np.median(a[i])
        (se_a,), dof_a = parity.batch_median_se(a[i][:, :, None])
        (se_b,), dof_b = parity.batch_median_se(b[i][:, :, None])
        z_new.append(parity.z_between(diff, se_a, dof_a, se_b, dof_b)[0])
        z_tool.append(diff / np.hypot(parity.median_se(a[i])[0],
                                      parity.median_se(b[i])[0]))
    assert 0.8 <= np.std(z_new) <= 1.25, np.std(z_new)
    if taus == 8 and not swapped:
        assert np.std(z_tool) > 1.25, np.std(z_tool)


def test_ar1_batch_factor():
    """No correction for independent draws or batches long against tau;
    for B = 4 batches of 2 tau, the exact AR(1) ratio (the covariance of
    the batch means summed by brute force)."""
    assert parity.ar1_batch_factor(4, 100, 1.0) == 1.0
    assert parity.ar1_batch_factor(10, 10_000, 5.0) == pytest.approx(
        1.0, abs=1e-3)
    tau, n_blocks, length = 9.0, 4, 18
    rho = (tau - 1) / (tau + 1)
    k = np.arange(n_blocks * length)
    cov = rho ** np.abs(np.subtract.outer(k, k))
    a = np.kron(np.eye(n_blocks), np.full((1, length), 1 / length))
    cm = a @ cov @ a.T
    var_mean = cm.sum() / n_blocks ** 2
    mean_s2 = (np.trace(cm) - cm.sum() / n_blocks) / (n_blocks - 1)
    assert parity.ar1_batch_factor(n_blocks, length, tau) == pytest.approx(
        np.sqrt(var_mean * n_blocks / mean_s2), rel=1e-9)


def test_z_between_is_a_normal_quantile():
    """Many blocks: z is the t ratio; few: it shrinks to the normal
    quantile of the same tail probability."""
    z, t, dof = parity.z_between(4.0, 1.0, 10_000, 1.0, 10_000)
    assert t == pytest.approx(4 / np.sqrt(2))
    assert z == pytest.approx(t, rel=1e-3)
    assert dof == pytest.approx(20_000)
    z, t, dof = parity.z_between(-6.0, 1.0, 3, 1.0, 3)
    assert dof == pytest.approx(6.0) and t == pytest.approx(-6 / np.sqrt(2))
    assert -3.1 < z < -2.5
    assert parity.z_between(0.0, 0.0, 3, 0.0, 3)[0] == 0.0


# ---- the density cases ------------------------------------------------------

@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX references at the small size: simult_counts' chain and
    thetas, mc 'exact' on rk4 and the faithful likelihood at its thetas,
    simple v2 with its own chain."""
    ref_mod = _load("parity_reference")
    out = tmp_path_factory.mktemp("parity_paths")
    quiet = dict(log=lambda *a: None)
    meta, arrays = ref_mod.reference_case(
        "simult_counts", ref_mod.Sizes(**SMALL), **quiet)
    ref_mod.write_case(meta, arrays, out)
    for name in ("simult_mc_rk4_exact", "simult_counts_faithful"):
        chunk = 16 if parity.CASES[name]["sampling"] == "mc" else None
        m, a = ref_mod.reference_case(
            name, ref_mod.Sizes(**SMALL, chunk=chunk),
            thetas=arrays["thetas"], **quiet)
        m["chain"] = meta["chain"]      # whose thetas these are
        ref_mod.write_case(m, a, out)
    m, a = ref_mod.reference_case("simple_v2", ref_mod.Sizes(**SIMPLE),
                                  **quiet)
    ref_mod.write_case(m, a, out)
    return out


@pytest.fixture(scope="module")
def port_script():
    return _load("posterior_parity")


@pytest.mark.parametrize("case", ["simult_mc_rk4_exact",
                                  "simult_counts_faithful", "simple_v2"])
def test_port_passes_against_the_jax_package(refs, port_script, case):
    torch.manual_seed(0)
    result = port_script.run_case(case, "cpu", ref_dir=refs, chain=False)
    dens = result["density"]
    assert result["verdict"] == "PASS", dens
    assert dens["n_finite"] + dens["n_neither"] == dens["n_thetas"]
    assert dens["neg_inf"]["verdict"] == "PASS"


def test_faithful_reference_keeps_its_finite_counts(refs):
    """The faithful case's reference holds the number of finite repeats
    per theta and statistics over those alone."""
    ref = parity.load_reference(refs / "simult_counts_faithful.npz")
    n_fin = ref.arrays["lp_n_finite"]
    assert n_fin.shape == (16,) and np.all(n_fin <= 8)
    ok = n_fin > 1
    assert np.all(np.isfinite(ref.arrays["lp_mean"][ok]))
    assert ref.meta["likelihood"] == "reference"


def test_simple_v2_chain_runs_from_the_clis_start(refs):
    """The port's DE chain of simple v2 from the CLI's start (truth x 1.02
    + 0.01 N(0, 1)) at the JAX chain's 32 walkers, 20 + 20 steps of it:
    its walkers move and its dz table against the JAX chain is finite.
    (So short a chain has not left the start ball: dz is the card's to
    gate, at the CLI's 100 walkers and 200k draws and the JAX chain's
    steps.)"""
    ref = parity.load_reference(refs / "simple_v2.npz")
    problem = parity.build_problem(ref.meta, "cpu")
    ref.meta["chain"] = dict(ref.meta["chain"], burnin=20, main=20)
    pos, acc = parity.run_port_chain(ref, problem, seed=3)
    table = parity.dz_table(ref.meta["chain"]["summary"], pos, ref.names)
    assert pos.shape == (20, 32, 6)
    assert np.isfinite(table["worst_dz"]) and np.isfinite(
        table["worst_z_se"])
    assert 0 < acc < 1
    with np.load(refs / "simple_v2.npz") as z:
        assert z["chain_block_medians"].shape[1] == 6


@pytest.mark.parametrize("case", ["simult_mc_rk4_exact", "simple_v2"])
def test_k3_paths_catch_a_quarter_sigma_shift(refs, port_script, case):
    """The first parameter moved by 0.25 posterior sigma (towards the box's
    middle) against the same JAX values: the chi-square gate fails."""
    ref = parity.load_reference(refs / f"{case}.npz")
    problem = parity.build_problem(ref.meta, "cpu")
    shifted = parity.shifted_thetas(ref, problem, 0.25)
    result = port_script.run_case(case, "cpu", ref_dir=refs, chain=False,
                                  thetas=shifted)
    assert result["density"]["chi2_verdict"] == "REVIEW", result["density"]
    assert result["verdict"] == "REVIEW"


def test_density_fails_a_theta_finite_on_one_side():
    """A theta whose port repeats are all -inf where the JAX package's are
    finite is not dropped: the density verdict fails, and so does the
    -inf share test when enough thetas do it."""
    rng = np.random.default_rng(5)
    n, r = 24, 16
    thetas = rng.standard_normal((n, 2))
    sd = np.full(n, 1.0)
    mean = -500 + rng.standard_normal(n) * 0.1
    port_mean, port_n = mean.copy(), np.full(n, r)
    port_mean[3], port_n[3] = -np.inf, 0
    out = parity.density_parity(mean, sd, port_mean, sd, r, thetas,
                                ["x", "y"], port_n=port_n)
    assert out["verdict"] == "REVIEW"
    port_n[:6] = 0
    shares = parity.neg_inf_shares(np.full(n, r), port_n, r)
    assert shares["verdict"] == "REVIEW"
    assert parity.neg_inf_shares(np.full(n, r), np.full(n, r),
                                 r)["verdict"] == "PASS"


# ---- the evidence cases -----------------------------------------------------

@pytest.fixture(scope="module")
def pt_refs(tmp_path_factory):
    ref_mod = _load("parity_reference")
    out = tmp_path_factory.mktemp("parity_pt")
    ref_mod.pt_reference("pt_shifting_gaussian", out_dir=out,
                         log=lambda *a: None, case=PT_SMALL)
    return out


def test_pt_evidence_passes_against_the_jax_package(pt_refs, port_script):
    """The analytic shifting-Gaussian PT on the JAX package's data, three
    seeds a package: ln Z within 4 noise and the cold chains' dz."""
    result = port_script.run_evidence("pt_shifting_gaussian", "cpu",
                                      ref_dir=pt_refs)
    assert result["verdict"] == "PASS", (result["evidence"],
                                         parity.format_dz(
                                             result["cold_chain"]))
    assert len(result["runs"]) == 3


def test_evidence_gate_catches_one_nat(pt_refs, port_script):
    """The port's ln Z moved by 1 nat against the same JAX seeds fails the
    evidence gate (the seeds' sd is a few hundredths of a nat)."""
    ref = parity.load_reference(pt_refs / "pt_shifting_gaussian.npz")
    jax_ln_z = [r["ln_z"] for r in ref.meta["runs"]]
    assert parity.evidence_parity(jax_ln_z, jax_ln_z[::-1])["verdict"] \
        == "PASS"
    moved = parity.evidence_parity(jax_ln_z, np.add(jax_ln_z, 1.0))
    assert moved["verdict"] == "REVIEW", moved


def test_pt_tof_loglike_matches_the_jax_package():
    """The ``-model tof`` evidence case's posterior as the port's CLI
    builds it (``cli/shifting_gaussian.py::tof_pt_setup``) on the JAX
    package's observed arrays: the spec fields the reference records are
    the port's, and its log-likelihood law at the JAX package's initial
    walkers agrees (density parity over 8 repeats; the CLI's 50k
    draws)."""
    ref_mod = _load("parity_reference")
    import jax

    from mcmctoffitting_tpu_torch.cli import shifting_gaussian as cli_sg

    case = parity.PT_CASES["pt_shifting_gaussian_tof"]
    observed, loglike, _, init, names, fields = ref_mod.pt_setup(case)
    thetas = np.asarray(init(jax.random.PRNGKey(4), 1, 12))[0]
    keys = jax.random.split(jax.random.PRNGKey(5), 8 * 12)
    jax_ll = np.asarray(jax.jit(jax.vmap(loglike))(
        np.tile(thetas, (8, 1)), keys), np.float64).reshape(8, 12).T
    problem, port_obs, port_ll, _, _ = cli_sg.tof_pt_setup(
        0, 1, 12, "cpu", observed=observed)
    assert port_obs is observed
    for field, want in fields["spec_fields"].items():
        assert getattr(problem.spec, field) == want, field
    gen = torch.Generator().manual_seed(6)
    rows = torch.as_tensor(np.tile(thetas, (8, 1)))
    with torch.no_grad():
        lp = port_ll(rows, gen).double().numpy().reshape(8, 12).T
    out = parity.density_parity(jax_ll.mean(1), jax_ll.std(1, ddof=1),
                                lp.mean(1), lp.std(1, ddof=1), 8, thetas,
                                names)
    assert out["verdict"] == "PASS", out


# ---- the chain gate's reach ---------------------------------------------------

@pytest.mark.parametrize("k", [0.1, 0.3])
@pytest.mark.parametrize("case", parity.DE_CHAIN_CASES)
def test_chain_gate_on_a_planted_shift(case, k):
    """A chain with the committed JAX reference chain's summary, moved by
    ``k`` posterior sigmas on every parameter, against that reference: dz
    reads k, z_se fails exactly where ``z_se_reach`` says (its t at the
    Welch dof of 4 blocks a side is ~9: at 0.1 sigma z_se fails 2 of
    simult counts' 8 parameters, 1 of oneBD's 9 and none of simple v2's
    6), and dz fails 0.3 sigma on all of them.  So on these chains the
    gate's sure reach is dz's 0.25 sigma."""
    summ = json.loads((REPO / "perf" / "parity" / f"{case}.json")
                      .read_text())["chain"]["summary"]
    moved = {}
    for name, row in summ.items():
        sigma = 0.5 * (row["q84"] - row["q16"])
        moved[name] = dict(row, **{q: row[q] + k * sigma
                                   for q in ("q16", "q50", "q84")})
    table = parity.dz_between(summ, moved, list(summ))
    for row in table["rows"]:
        assert row["dz"] == pytest.approx(k, rel=1e-6)
        assert (row["z_se"] >= parity.Z_SE_MAX) == (k >= row["z_se_reach"])
    reach = table["reach"]
    assert (table["verdict"] == "REVIEW") == (
        k >= min(parity.DZ_MAX, reach["z_se_best_sigma"]))
    assert reach["sigma"] == min(parity.DZ_MAX, reach["z_se_sigma"])
    if k > parity.DZ_MAX:
        assert all(row["dz"] >= parity.DZ_MAX for row in table["rows"])
        assert table["verdict"] == "REVIEW"


# ---- HMC against the JAX package's ------------------------------------------

def test_hmc_matches_the_jax_package_from_the_same_start(port_script):
    """Both packages' ``hmc_sample`` at their defaults (16 leapfrog steps
    jittered by 20%, dual averaging to 0.8) on the 'expected' posterior at
    the small size, in box-logit coordinates, from the same 8 walkers of
    the JAX package's initial-walker law, 40 + 40 transitions: the
    adapted step sizes agree within 20%, the acceptance within 0.08, and
    split R-hat tells the same story (neither has mixed along the
    beamE-eLoss ridge at the CLI's settings; both have on the last
    parameter)."""
    ref_mod = _load("parity_reference")
    from mcmctoffitting_tpu_torch.utils.diagnostics import split_rhat

    sizes = ref_mod.Sizes(**SMALL)
    jax_problem, observed, runs, fields, _ = ref_mod._case_setup(
        parity.CASES["simult_expected"], sizes)
    meta = {"case": "simult_expected", "model": "simult",
            "n_draws": sizes.n_draws, "sampling": "expected",
            "likelihood": "poisson", **fields}
    problem = parity.build_problem(meta, "cpu")
    pos_j, out_j, cloud = ref_mod.jax_hmc(jax_problem, observed, 8, 40, 40, 0)
    torch.manual_seed(0)
    pos_p, info = port_script.run_hmc(None, problem, chains=8, warmup=40,
                                      steps=40, observed=runs, cloud=cloud)
    assert pos_p.shape == pos_j.shape == (40, 8, 6)
    assert info["step_size"] == pytest.approx(float(out_j.step_size),
                                              rel=0.2)
    assert info["accept_prob"] == pytest.approx(
        float(np.mean(np.asarray(out_j.accept_prob))), abs=0.08)
    rhat_j, rhat_p = split_rhat(pos_j), np.asarray(info["split_rhat"])
    assert rhat_j[0] > 1.1 and rhat_p[0] > 1.1
    assert rhat_j[-1] < 1.1 and rhat_p[-1] < 1.1
