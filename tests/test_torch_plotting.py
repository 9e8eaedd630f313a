"""The port's plotting module (mcmctoffitting_tpu_torch.utils.plotting, a
copy of the JAX package's: numpy + matplotlib) draws the same figures as
the JAX package's from the same inputs: every axes' lines, collections,
patches, labels and titles equal; the files it writes are figures.  Skips
where matplotlib is not installed (the card's machine has none)."""
import os

import numpy as np
import pytest

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

from mcmctoffitting_tpu.utils import plotting as jplotting  # noqa: E402
from mcmctoffitting_tpu_torch.utils import plotting as tplotting  # noqa: E402

RNG = np.random.default_rng(0)
CHAIN = np.array([1878.4, 850.0, 170.0]) + np.array(
    [5.0, 20.0, 10.0]) * RNG.standard_normal((30, 8, 3))
PROBS = -1000.0 + RNG.standard_normal((30, 8))
OBS = RNG.poisson(200.0, 25).astype(float)
BANDS = np.sort(RNG.normal(200.0, 15.0, (3, 25)), axis=0)
ENERGIES = np.linspace(450.0, 1150.0, 8)
TEMPLATE_SAMPLES = np.concatenate([RNG.normal([1.1, 0.6, 1.5], 0.05, (200, 3)),
                                   RNG.normal(100.0, 5.0, (200, 8))], axis=1)

CASES = {
    "trace_plot": ((CHAIN, ["beamE", "eLoss", "scale"]), {}),
    "lnprob_scatter": ((CHAIN, PROBS, 1, "eLoss"), {}),
    "param_hist": ((CHAIN, 2), {"bins": 20}),
    "corner_plot": ((CHAIN[-10:], ["a", "b", "c"]), {}),
    "model_overlay_plot": ((OBS, OBS * 1.05), {}),
    "initial_energy_plot": ((2450.0, 1400.0, 50.0, 0.4), {"n_samples": 5000}),
    "unfolded_spectrum_plot": ((ENERGIES, TEMPLATE_SAMPLES), {}),
    "ppc_band_plot": ((OBS, BANDS), {}),
}


def _figure_data(fig):
    """Everything a figure shows, as plain values."""
    out = []
    for ax in fig.axes:
        out.append(("labels", ax.get_xlabel(), ax.get_ylabel(),
                    ax.get_title()))
        out.extend(("line", np.asarray(ln.get_xydata()).tolist())
                   for ln in ax.lines)
        for c in ax.collections:
            paths = [p.vertices.tolist() for p in c.get_paths()]
            out.append(("collection", type(c).__name__,
                        np.asarray(c.get_offsets()).tolist(), paths))
        out.extend(("patch", p.get_x(), p.get_y(), p.get_width(),
                    p.get_height()) for p in ax.patches
                   if hasattr(p, "get_height"))
        out.append(("texts", [t.get_text() for t in ax.texts]))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_figure_as_the_jax_package(name, tmp_path):
    import matplotlib.pyplot as plt
    args, kwargs = CASES[name]
    got = getattr(tplotting, name)(*args, **kwargs)
    want = getattr(jplotting, name)(*args, **kwargs)
    assert _figure_data(got) == _figure_data(want)
    plt.close(got)
    plt.close(want)
    path = tmp_path / f"{name}.png"
    getattr(tplotting, name)(*args, filename=str(path), **kwargs)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(path) > 5_000


def test_every_function_is_a_copy_of_the_jax_one():
    """A copy, function for function: the same public names, and each
    function's source equal to the JAX package's."""
    import inspect
    names = [n for n, v in vars(jplotting).items()
             if inspect.isfunction(v) and v.__module__ == jplotting.__name__]
    assert names
    for n in names:
        assert inspect.getsource(getattr(tplotting, n)) == \
            inspect.getsource(getattr(jplotting, n)), n
