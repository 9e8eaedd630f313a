"""The port imports without jax, triton or nvcc, and builds nothing at
import time."""
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
import pkgutil, importlib
import mcmctoffitting_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
from mcmctoffitting_tpu_torch.ops import cuda_build
assert cuda_build.load_library.cache_info().currsize == 0   # nothing built
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'triton')]
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


def test_kernel_modules_import_without_nvcc():
    proc = _run("import mcmctoffitting_tpu_torch.ops.cuda_poisson, "
                "mcmctoffitting_tpu_torch.ops.cuda_tof; print('ok')",
                {"PATH": "/nonexistent"})
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_no_jax_import_in_sources():
    for path in (REPO / "mcmctoffitting_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split("#")[0].split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "triton"), path
                if words[1].startswith("mcmctoffitting_tpu."):
                    # only the jax-free modules of the JAX package
                    assert words[1] in ("mcmctoffitting_tpu.constants",
                                        "mcmctoffitting_tpu.config"), path
                if words[1] == "mcmctoffitting_tpu":
                    assert words[3:] in (["config,", "constants"],
                                         ["constants,", "config"]), path


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
    assert {"poisson.cu", "tof_hist.cu", "philox.cuh"} <= names
    assert cuda_build.source_hash() == cuda_build.source_hash()
