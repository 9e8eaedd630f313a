"""Chain text, convergence diagnostics, data files and checkpoints of the
port (mcmctoffitting_tpu_torch) against the JAX package, on the CPU.

* The port's ``append_chain_text`` writes the JAX package's bytes, with
  the native codec on both sides and with it switched off on both (the
  Python writer: numpy's array repr, wrapped lines included), and each
  package reads the other's files.
* The native codec builds into ``build/native/`` and parses as the
  Python reader does.
* ``chain_summary`` and ``format_summary`` equal the JAX package's on an
  AR(1) chain.
* The TSV reader, ``select_window`` and the writer give the JAX package's
  arrays and bytes.
* A checkpoint restores both generators.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.utils import chain_io as jchain_io
from mcmctoffitting_tpu.utils import data_io as jdata_io
from mcmctoffitting_tpu.utils import diagnostics as jdiag
from mcmctoffitting_tpu.utils import native as jnative
from mcmctoffitting_tpu_torch.sampler import EnsembleState
from mcmctoffitting_tpu_torch.utils import chain_io as tchain_io
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io
from mcmctoffitting_tpu_torch.utils import diagnostics as tdiag
from mcmctoffitting_tpu_torch.utils import native as tnative

REPO = Path(__file__).resolve().parent.parent


def _chain(n_dim, dtype, seed=0, n_steps=3, n_walkers=4):
    rng = np.random.default_rng(seed)
    scale = np.geomspace(0.1, 5e4, n_dim)
    pos = (rng.standard_normal((n_steps, n_walkers, n_dim)) * scale).astype(
        dtype)
    lp = (-1e5 * rng.random((n_steps, n_walkers))).astype(dtype)
    lp[0, 0] = -np.inf
    return pos, lp


def _no_native(monkeypatch):
    def refuse(*args):
        raise RuntimeError("native codec switched off")

    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "format_chain_text_native", refuse)
        monkeypatch.setattr(mod, "parse_chain_text_native", refuse)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("n_dim,dtype", [(6, np.float32), (9, np.float32),
                                         (20, np.float64)])
def test_append_chain_text_writes_the_jax_bytes(tmp_path, monkeypatch,
                                                native, n_dim, dtype):
    """Same bytes for one (W, D) step and for (S, W, D) steps, appended;
    D = 20 wraps numpy's repr over several lines."""
    if not native:
        _no_native(monkeypatch)
    pos, lp = _chain(n_dim, dtype)
    paths = []
    for name, mod in (("jax", jchain_io), ("port", tchain_io)):
        path = tmp_path / f"{name}.dat"
        mod.append_chain_text(str(path), pos[0], lp[0], mode="w")
        mod.append_chain_text(str(path), pos[1:], lp[1:])
        paths.append(path.read_bytes())
    assert paths[0] == paths[1]
    if not native and n_dim == 20:
        assert paths[0].count(b"\n") > 3 * 4      # wrapped lines


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_each_package_reads_the_others_files(tmp_path, monkeypatch, writer,
                                             reader, native):
    if not native:
        _no_native(monkeypatch)
    mods = {"jax": jchain_io, "port": tchain_io}
    for n_dim in (9, 20):
        pos, lp = _chain(n_dim, np.float32, seed=n_dim)
        path = str(tmp_path / f"{writer}_{n_dim}.dat")
        mods[writer].append_chain_text(path, pos, lp, mode="w")
        got = mods[reader].read_chain_text(path)
        want = mods[writer].read_chain_text(path)
        assert got[2:] == want[2:] == (n_dim, 4, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], pos, rtol=1e-7)


def test_numpy_wrapped_lines_parse(tmp_path):
    """A file written row by row with ``format`` of a float64 theta, as in
    tests/test_chain_io.py: each package reads the wrapped rows."""
    path = tmp_path / "chain.dat"
    theta = np.arange(20, dtype=np.float64) * 1.234567
    with open(path, "w") as f:
        for k in range(2):
            f.write("{0} {1} {2}\n".format(k, theta, -12.5))
    for mod in (jchain_io, tchain_io):
        chain, probs, n_params, n_walkers, n_steps = mod.read_chain_text(
            str(path))
        assert (n_steps, n_walkers, n_params) == (1, 2, 20)
        np.testing.assert_allclose(chain[0, 0], theta, rtol=1e-6)
        np.testing.assert_array_equal(probs, [[-12.5, -12.5]])
    text = path.read_text()
    for got, want in zip(tchain_io._parse_chain_text_py(text),
                         jchain_io._parse_chain_text_py(text)):
        np.testing.assert_array_equal(got, want)


def test_native_codec_builds_outside_the_source_tree():
    """The codec parses as the Python reader does, and its library lies
    under build/native/, not next to chaincodec.cpp."""
    pos, lp = _chain(7, np.float64, seed=3)
    text = tnative.format_chain_text_native(pos, lp)
    for got, want in zip(tnative.parse_chain_text_native(text),
                         tchain_io._parse_chain_text_py(text)):
        np.testing.assert_array_equal(got, want)
    lib = Path(tnative._build())
    assert lib.is_relative_to(REPO / "build" / "native")
    assert not list(Path(tnative.__file__).parent.glob("*.so"))


def test_empty_chain_file_raises(tmp_path):
    path = tmp_path / "empty.dat"
    path.write_text("\n  \n")
    with pytest.raises(ValueError, match="empty or unparseable"):
        tchain_io.read_chain_text(str(path))


def _ar1(n_steps=400, n_walkers=8, n_dim=3, rho=0.9, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_steps, n_walkers, n_dim))
    noise = rng.standard_normal(x.shape)
    for s in range(1, n_steps):
        x[s] = rho * x[s - 1] + noise[s]
    return x


@pytest.mark.parametrize("n_steps", [6, 60, 400])
def test_chain_summary_equals_the_jax_one(n_steps):
    chain = _ar1(n_steps)
    chain[:, 0, 1] = 2.5        # a stuck walker: rho = 1 on that trace
    got, want = tdiag.chain_summary(chain), jdiag.chain_summary(chain)
    assert got.keys() == want.keys()
    for key in ("tau", "ess", "rhat"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["converged"] == want["converged"]
    assert tdiag.format_summary(got) == jdiag.format_summary(want)
    np.testing.assert_array_equal(tdiag.effective_sample_size(chain),
                                  jdiag.effective_sample_size(chain))


def test_data_files_equal_in_both_packages(tmp_path):
    rng = np.random.default_rng(5)
    edges = np.arange(40.0, 260.0, 4.0)
    counts = rng.poisson(30.0, (edges.size, 3)).astype(float)
    paths = []
    for name, mod in (("jax", jdata_io), ("port", tdata_io)):
        path = tmp_path / f"{name}.tsv"
        mod.write_multi_standoff_tof_data(str(path), edges, counts)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for n_runs in (2, 3):
        got = tdata_io.read_multi_standoff_tof_data(str(paths[0]), n_runs)
        want = jdata_io.read_multi_standoff_tof_data(str(paths[0]), n_runs)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (edges.size, 1 + n_runs)
        for run in range(n_runs):
            for lo, hi in ((80.0, 180.0), (40.0, 259.0), (130.0, 175.0)):
                for g, w in zip(tdata_io.select_window(got, run, lo, hi),
                                jdata_io.select_window(want, run, lo, hi)):
                    np.testing.assert_array_equal(g, w)


def test_checkpoint_round_trip_restores_both_generators(tmp_path):
    gen = torch.Generator().manual_seed(3)
    eval_gen = torch.Generator().manual_seed(4)
    torch.rand(5, generator=gen)
    torch.randint(0, 9, (7,), generator=eval_gen)
    state = EnsembleState(torch.randn(6, 4, generator=gen),
                          torch.randn(6, generator=gen), gen, eval_gen, 11)
    path = str(tmp_path / "main.ckpt.npz")
    tchain_io.save_checkpoint(path, state,
                              extra={"posterior_fp": np.arange(32, dtype=
                                                               np.uint8)})
    ckpt = tchain_io.load_checkpoint(path)
    assert ckpt.step == 11 and ckpt.generator_device == "cpu"
    np.testing.assert_array_equal(ckpt.positions, state.positions.numpy())
    np.testing.assert_array_equal(ckpt.log_probs, state.log_probs.numpy())
    np.testing.assert_array_equal(ckpt.extra["posterior_fp"], np.arange(32))
    gen2, eval2 = torch.Generator(), torch.Generator()
    gen2.set_state(ckpt.generator_state)
    eval2.set_state(ckpt.eval_generator_state)
    assert torch.equal(torch.rand(8, generator=gen2),
                       torch.rand(8, generator=gen))
    assert torch.equal(torch.randint(0, 1 << 30, (8,), generator=eval2),
                       torch.randint(0, 1 << 30, (8,), generator=eval_gen))
    with np.load(path) as z:    # the JAX package's layout, less its key
        assert {"positions", "log_probs", "step",
                "extra_posterior_fp"} <= set(z.files)
