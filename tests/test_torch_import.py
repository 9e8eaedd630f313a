"""The port imports without jax, triton, nvcc or anything of the JAX
package, and builds nothing at import time; its copies of the JAX
package's constants and configuration hold the same values."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
sys.modules['jax'] = None          # any 'import jax' now raises
sys.modules['triton'] = None
sys.modules['mcmctoffitting_tpu'] = None   # nor anything of the JAX package
import pkgutil, importlib
import mcmctoffitting_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
from mcmctoffitting_tpu_torch.ops import cuda_build
assert cuda_build.load_library.cache_info().currsize == 0   # nothing built
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton',
                                  'mcmctoffitting_tpu')]
assert not loaded, loaded
print(len(names))
"""


def _run(code, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_or_triton():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15      # every module imported


NEW_MODULES = ("cli._driver", "cli._entry", "cli.simult_fit",
               "cli.csi_onebd", "ops.fixed_point", "utils.chain_io",
               "utils.diagnostics", "utils.data_io", "utils.native",
               "sampler.transforms", "sampler._adapt", "sampler.hmc",
               "sampler.nuts", "utils.optimize", "utils.ppc", "cli.ppc",
               "utils.plotting", "cli.plot_chain", "utils.profiling",
               "compat", "compat.emcee", "models.simple", "models.templates",
               "models.csi2016", "models.fixed_params", "cli.simple_tof",
               "cli.template_fit", "sampler.pt", "models.shifting_gaussian",
               "cli.shifting_gaussian", "parallel", "parallel.mesh",
               "parallel.distributed", "parallel.launch", "utils.parity")


def test_every_module_is_among_those_imported():
    """The walk above reaches the drivers, chain I/O, diagnostics, the
    native codec's bindings (which build nothing at import), the gradient
    samplers, the optimisers, the post-processing modules (PPC, plotting,
    which imports no matplotlib until it draws, plot_chain, profiling, the
    emcee shim), parallel tempering with its shifting-Gaussian study, and
    the walker sharding over torch.distributed ranks, and the posterior
    parity protocols."""
    import pkgutil

    import mcmctoffitting_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    assert {f"mcmctoffitting_tpu_torch.{m}" for m in NEW_MODULES} <= names


_RUN_CLI = """
import sys
sys.modules['jax'] = None
sys.modules['triton'] = None
sys.modules['mcmctoffitting_tpu'] = None
import runpy
sys.argv = [{name!r}, '-device', 'cpu', '-quitEarly', '1',
            '-nDrawsPerEval', '2000', '-fineGrid', '64']
runpy.run_module({name!r}, run_name='__main__', alter_sys=True)
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton',
                                  'mcmctoffitting_tpu')]
assert not loaded, loaded
"""


@pytest.mark.parametrize("cli", ["simult_fit", "csi_onebd"])
def test_cli_entry_runs_without_the_jax_package(cli, tmp_path):
    """``python -m mcmctoffitting_tpu_torch.cli.<cli>`` with jax and the
    JAX package blocked: set-up on the CPU, then -quitEarly."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c",
         _RUN_CLI.format(name=f"mcmctoffitting_tpu_torch.cli.{cli}")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "quitEarly: setup complete" in proc.stdout


_RUN_POST = """
import sys
for blocked in ('jax', 'triton', 'mcmctoffitting_tpu', 'matplotlib'):
    sys.modules[blocked] = None
import numpy as np
from mcmctoffitting_tpu_torch.cli import plot_chain, ppc
from mcmctoffitting_tpu_torch.utils import chain_io
rng = np.random.default_rng(0)
chain = (np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 5e4])
         * (1 + 1e-3 * rng.standard_normal((10, 4, 6))))
chain_io.append_chain_text('chain.dat', chain, -rng.random((10, 4)))
ppc.main(['-chainFilename', 'chain.dat', '-device', 'cpu', '-nRuns', '2',
          '-nSamplesFromTOF', '2000', '-nChainEntries', '2'])
plot_chain.main(['-filename', 'chain.dat'])
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton',
                                  'mcmctoffitting_tpu', 'matplotlib')]
assert not loaded, loaded
"""


def test_post_processing_clis_run_without_jax_or_matplotlib(tmp_path):
    """cli.ppc and cli.plot_chain with jax, the JAX package and matplotlib
    blocked (the card's machine has no matplotlib): the files of the PPC,
    the diagnostics, and for each CLI's figures the one line that says
    matplotlib is missing."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _RUN_POST], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(
        "plotting skipped: matplotlib is not installed") == 2
    assert "wrote ppc_sdef.txt" in proc.stdout
    assert "diagnostics:" in proc.stdout
    assert {"ppc_run0_bands.txt", "ppc_run1_bands.txt",
            "ppc_sdef.txt"} <= set(os.listdir(tmp_path))


_RUN_MODELS = """
import sys
for blocked in ('jax', 'triton', 'mcmctoffitting_tpu', 'matplotlib'):
    sys.modules[blocked] = None
import numpy as np
from mcmctoffitting_tpu_torch.cli import ppc, simple_tof, template_fit
from mcmctoffitting_tpu_torch.utils import chain_io
simple_tof.DEBUG_SIZES = (8, 2, 2000)
simple_tof.main(['--model', 'v2', '--debug', '-device', 'cpu'])
from mcmctoffitting_tpu_torch.models import templates
rng = np.random.default_rng(0)
templates.save_templates_csv('templates.csv', [
    rng.random((32, w.n_bins)) for w in
    templates.TemplateFitProblem(device='cpu').windows])
template_fit.DEBUG_SIZES = (300, 8, 2)
template_fit.main(['--debug', '-device', 'cpu'])
chain = (np.array([900.0, 0.05, 1.0, 1e4])
         * (1 + 1e-3 * rng.standard_normal((10, 4, 4))))
chain_io.append_chain_text('old.dat', chain, -rng.random((10, 4)))
ppc.main(['-chainFilename', 'old.dat', '-model', 'csi2016', '-device',
          'cpu', '-nRuns', '2', '-nSamplesFromTOF', '1000',
          '-nChainEntries', '2'])
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton',
                                  'mcmctoffitting_tpu', 'matplotlib')]
assert not loaded, loaded
"""


def test_remaining_model_clis_run_without_jax_or_matplotlib(tmp_path):
    """cli.simple_tof, cli.template_fit (on a template cache) and cli.ppc
    -model csi2016 with jax, the JAX package and matplotlib blocked, at
    tiny sizes on the CPU: their files, and the missing-matplotlib line
    of template_fit."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _RUN_MODELS], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "plotting skipped: matplotlib is not installed" in proc.stdout
    assert "wrote ppc_sdef.txt" in proc.stdout
    assert "loading templates from templates.csv" in proc.stdout
    assert {"mainchain.dat", "tmpl_burninchain.dat",
            "ppc_run1_bands.txt"} <= set(os.listdir(tmp_path))


_RUN_PT = """
import sys
for blocked in ('jax', 'triton', 'mcmctoffitting_tpu', 'matplotlib'):
    sys.modules[blocked] = None
from mcmctoffitting_tpu_torch.cli import shifting_gaussian
from mcmctoffitting_tpu_torch.models import simult
default_spec = simult.default_spec
simult.default_spec = lambda n_samples, **kw: default_spec(8000, **kw)
shifting_gaussian.main(['--debug', '-device', 'cpu', '-nSamples', '100'])
shifting_gaussian.main(['-model', 'tof', '-device', 'cpu', '-nTemps', '2',
                        '-ptWalkers', '4', '-ptBurnin', '1', '-ptSteps', '2',
                        '-thin', '1'])
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton',
                                  'mcmctoffitting_tpu', 'matplotlib')]
assert not loaded, loaded
"""


def test_shifting_gaussian_cli_runs_without_jax_or_matplotlib(tmp_path):
    """cli.shifting_gaussian, both branches, with jax, the JAX package and
    matplotlib blocked, at tiny sizes on the CPU (8k draws for -model
    tof): its lines and files."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _RUN_PT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '{"pt_cold_medians"' in proc.stdout
    assert "cold-chain beamE 95% span" in proc.stdout
    assert {"sg_chain.dat", "sg_pt_coldchain.dat"} <= set(
        os.listdir(tmp_path))


def test_console_scripts_do_not_collide():
    """pyproject names the port's seven scripts beside the JAX package's."""
    import tomllib
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    entries = {"mcmctof-torch-simult-fit": "simult_fit",
               "mcmctof-torch-csi-onebd": "csi_onebd",
               "mcmctof-torch-ppc": "ppc",
               "mcmctof-torch-plot-chain": "plot_chain",
               "mcmctof-torch-simple-tof": "simple_tof",
               "mcmctof-torch-template-fit": "template_fit",
               "mcmctof-torch-shifting-gaussian": "shifting_gaussian"}
    from mcmctoffitting_tpu_torch.cli import _entry
    for script, fn in entries.items():
        assert scripts[script] == \
            f"mcmctoffitting_tpu_torch.cli._entry:{fn}"
        assert callable(getattr(_entry, fn))
    assert len(set(scripts)) == len(scripts) == 14


def test_kernel_modules_import_without_nvcc():
    proc = _run("import mcmctoffitting_tpu_torch.ops.cuda_poisson, "
                "mcmctoffitting_tpu_torch.ops.cuda_tof, "
                "mcmctoffitting_tpu_torch.ops.cuda_hist, "
                "mcmctoffitting_tpu_torch.ops.cuda_transport; print('ok')",
                {"PATH": "/nonexistent"})
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def _imported_roots(path):
    """First component of every module an import line of ``path`` names
    (absolute imports only)."""
    for line in path.read_text().splitlines():
        words = line.split("#")[0].replace(",", " ").split()
        if words[:1] == ["from"] and len(words) > 1:
            yield words[1].split(".")[0]
        elif words[:1] == ["import"]:
            for word in words[1:]:
                if word == "as":
                    break
                yield word.split(".")[0]


@pytest.mark.parametrize("where", ["mcmctoffitting_tpu_torch",
                                   "chip_smoke.py",
                                   "perf/posterior_parity.py"])
def test_no_jax_import_in_sources(where):
    paths = ([REPO / where] if where.endswith(".py")
             else sorted((REPO / where).rglob("*.py")))
    for path in paths:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "triton",
                            "mcmctoffitting_tpu"}, path


def test_chip_smoke_imports_without_the_jax_package():
    proc = _run("import sys; sys.modules['jax'] = None; "
                "sys.modules['mcmctoffitting_tpu'] = None; "
                "import runpy; runpy.run_path('chip_smoke.py', "
                "run_name='not_main'); print('ok')")
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_posterior_parity_script_imports_without_the_jax_package():
    """The card's side of the posterior parity (the card's machine has no
    jax) imports with jax and the JAX package blocked, and loads neither."""
    proc = _run("import sys; sys.modules['jax'] = None; "
                "sys.modules['mcmctoffitting_tpu'] = None; "
                "import runpy; runpy.run_path('perf/posterior_parity.py', "
                "run_name='not_main'); "
                "loaded = [m for m, mod in sys.modules.items() if mod is not "
                "None and m.split('.')[0] in ('jax', 'jaxlib', "
                "'mcmctoffitting_tpu')]; "
                "assert not loaded, loaded; print('ok')")
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_constants_copies_hold_the_same_values():
    from mcmctoffitting_tpu import config as jconfig
    from mcmctoffitting_tpu import constants as jconst
    from mcmctoffitting_tpu_torch import config as tconfig
    from mcmctoffitting_tpu_torch import constants as tconst
    for name in ("SIMULTFIT_ED_BINNING", "SIMULTFIT_X_BINNING"):
        got, want = getattr(tconfig, name), getattr(jconfig, name)
        assert (got.lo, got.hi, got.n) == (want.lo, want.hi, want.n), name
        assert (got.centers == want.centers).all(), name
        assert (got.edges == want.edges).all(), name
    for win in ("close", "mid", "far", "production"):
        got, want = tconst.tof_windows[win], jconst.tof_windows[win]
        assert (got.lo, got.hi, got.n_bins) == (want.lo, want.hi,
                                                want.n_bins), win
    import dataclasses
    assert (dataclasses.asdict(tconst.TUNL_SSA_CSI)
            == dataclasses.asdict(jconst.TUNL_SSA_CSI))
    for name in ("close", "mid", "far", "production"):
        assert (tconst.TUNL_SSA_CSI.standoff(name)
                == jconst.TUNL_SSA_CSI.standoff(name)), name
    for ours, theirs in ((tconst.masses, jconst.masses),
                         (tconst.physics, jconst.physics),
                         (tconst.q_values, jconst.q_values)):
        for field in dataclasses.fields(ours):
            assert (getattr(ours, field.name)
                    == getattr(theirs, field.name)), field.name


def test_onebd_constants_copies_hold_the_same_values():
    import dataclasses

    import numpy as np

    from mcmctoffitting_tpu import config as jconfig
    from mcmctoffitting_tpu import constants as jconst
    from mcmctoffitting_tpu_torch import config as tconfig
    from mcmctoffitting_tpu_torch import constants as tconst
    for name in ("ONEBD_ED_BINNING_DEFAULT", "ONEBD_ED_BINNING_HARDCORE",
                 "ONEBD_X_BINNING_DEFAULT", "ONEBD_X_BINNING_HARDCORE"):
        got, want = getattr(tconfig, name), getattr(jconfig, name)
        assert (got.lo, got.hi, got.n) == (want.lo, want.hi, want.n), name
        assert (got.centers == want.centers).all(), name
        assert (got.edges == want.edges).all(), name
    for fn, args in (("deuteron_binning_onebd", ()),
                     ("deuteron_binning_onebd", (100,)),
                     ("x_binning_onebd", ()), ("x_binning_onebd", (10,))):
        got = getattr(tconfig, fn)(*args)
        want = getattr(jconfig, fn)(*args)
        assert (got.lo, got.hi, got.n) == (want.lo, want.hi, want.n), fn
    x = tconfig.ONEBD_X_BINNING_HARDCORE.centers
    assert np.array_equal(tconfig.cell_attenuation_coeffs(x),
                          jconfig.cell_attenuation_coeffs(x))
    assert (dataclasses.asdict(tconst.TUNL_SSA_CSI_ONEBD)
            == dataclasses.asdict(jconst.TUNL_SSA_CSI_ONEBD))
    for name in ("close", "mid", "far"):
        assert (tconst.TUNL_SSA_CSI_ONEBD.standoff(name)
                == jconst.TUNL_SSA_CSI_ONEBD.standoff(name)), name
        got, want = tconst.tof_windows_onebd[name], \
            jconst.tof_windows_onebd[name]
        assert (got.lo, got.hi, got.n_bins) == (want.lo, want.hi,
                                                want.n_bins), name
        assert got.n_bins == 25
    assert (dataclasses.asdict(tconst.onebd_consts)
            == dataclasses.asdict(jconst.onebd_consts))
    assert isinstance(tconst.tof_windows_onebd, tconst.TofWindowsOneBD)
    assert isinstance(tconst.onebd_consts, tconst.OneBDExperimentConsts)


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    from mcmctoffitting_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "_DEFAULT_NVCC",
                        Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def test_build_key_covers_every_source():
    from mcmctoffitting_tpu_torch.ops import cuda_build
    names = {p.name for p in cuda_build._sources()}
    assert {"poisson.cu", "tof_hist.cu", "philox.cuh", "weighted_hist.cu",
            "transport_moments.cu", "counts_rates.cu"} <= names
    assert cuda_build.source_hash() == cuda_build.source_hash()
