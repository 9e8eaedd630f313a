"""The A contraction's sparse kernel (``ops/cuda_contract.py``,
``csrc/a_contract.cu``) and the dispatch of ``ops/e0grid.py::contract``.

On the CPU: the ELL packing (scattered back it is A bit for bit, all-zero
columns and the widest column included; its width is the operator's own;
each column's rows ascend; the padding reads a row the column reads, with
value 0), a float64 gather over the packing against the dense float64
product, the grid's packing (once per device, not a buffer, not widened
by ``float64()``), and the dispatch: the dense product of
``rowwise_matmul`` on the CPU, in float64 and under a gradient, with no
launch.  Marked ``cuda`` and skipped without a GPU: the kernel against the
dense product on both counts presets' A (simultFit float32, oneBD
hardcore bfloat16-rounded) at 1, 37, 384 and 512 rows, each output
within the error bound of its fmaf chain (n + 1 float32 ulps of its
absolute sum, n its column's nonzeros) of the exact product, as the dense
product is (the largest gap, and whether the bits equal the dense
product's, are printed); a row's bits in every batch; a capture and
replay; one launch a contraction, none for float64 or a gradient.  On a machine with one (this
file imports no jax), run:

    python -m pytest --noconftest -m cuda -s tests/test_torch_a_contract.py
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.constants import onebd_consts
from mcmctoffitting_tpu_torch.models import onebd, simult
from mcmctoffitting_tpu_torch.ops.cuda_contract import (a_contract,
                                                        ell_pack)
from mcmctoffitting_tpu_torch.ops.cuda_poisson import poisson
from mcmctoffitting_tpu_torch.ops.cuda_rates import counts_rates
from mcmctoffitting_tpu_torch.ops.e0grid import (CountsRates, E0Grid,
                                                 contract,
                                                 moments_from_counts)
from mcmctoffitting_tpu_torch.ops.rowwise import rowwise_matmul
from mcmctoffitting_tpu_torch.utils import data_io

N_SAMPLES = 8000
# (beamE, eLoss, scale, s) balls of the presets; oneBD's beam is fixed
BALLS = {"simult": (np.array([1878.4, 850.0, 170.0, 0.5]),
                    np.array([10.0, 50.0, 20.0, 0.1])),
         "onebd": (np.concatenate([[onebd_consts.beam_reference_energy],
                                   data_io.ONEBD_TRUTH[:3]]),
                   np.array([0.0, 50.0, 10.0, 0.05]))}
RUNS = {"simult": 4, "onebd": 3}


def _spec(model, n_samples, fine_grid=None):
    if model == "simult":
        return simult.default_spec(n_samples, sampling="counts",
                                   fine_grid=fine_grid)
    return onebd.default_spec(n_samples, hardcore=True, sampling="counts",
                              fine_grid=fine_grid)


def _grid(model, device, n_samples=N_SAMPLES, fine_grid=128):
    spec = _spec(model, n_samples, fine_grid)
    return spec, E0Grid(spec.e0_grid_table, device=device,
                        a_dtype=spec.a_dtype)


def _moments(spec, grid, model, n_walkers, seed):
    """The counts path's moments of ``n_walkers`` walkers from the preset's
    ball, flattened to (walkers x runs, 4F) rows."""
    centre, width = BALLS[model]
    rng = np.random.default_rng(seed)
    params = torch.as_tensor(
        (centre + width * rng.standard_normal((n_walkers, 4)))
        .astype(np.float32), device=grid.a_matrix.device)
    rates = counts_rates(grid, params, spec.n_samples, spec.truncated,
                         spec.moment_closure)
    counts = poisson(rates.lam, (seed, seed + 1), n_runs=RUNS[model])
    moments, _ = moments_from_counts(
        grid, counts, CountsRates(*(t[:, None] for t in rates)))
    return moments.reshape(-1, 4 * grid.n_fine)


def _scatter_back(ell, n_cols):
    dense = torch.zeros((ell.n_rows, n_cols), dtype=ell.val.dtype)
    cols = torch.arange(n_cols).expand_as(ell.idx)
    return dense.index_put_((ell.idx.long(), cols), ell.val, accumulate=True)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sparse_operator():
    """A (12, 7) operator with all-zero columns (0 and 5), a column at the
    widest count (3: every row), a single entry at the last row (6) and a
    NaN entry (4)."""
    rng = np.random.default_rng(3)
    a = np.zeros((12, 7), np.float32)
    a[[1, 4, 9], 1] = rng.standard_normal(3)
    a[[0, 2], 2] = rng.standard_normal(2)
    a[:, 3] = rng.standard_normal(12)
    a[[5, 11], 4] = [np.nan, 2.5]
    a[11, 6] = -1.0
    return torch.as_tensor(a)


# --- on the CPU: the packing and the dispatch -------------------------------

@pytest.mark.parametrize("case", ["simult", "onebd", "sparse"])
def test_ell_packing_scatters_back_to_a_bit_for_bit(case):
    """Every nonzero once, in its column, with its value; the padding adds
    exact zeros; all-zero columns come back all zero."""
    a = (_sparse_operator() if case == "sparse"
         else _grid(case, "cpu")[1].a_matrix)
    ell = ell_pack(a)
    back = _scatter_back(ell, a.shape[1])
    assert torch.equal(_bits(torch.nan_to_num(back, nan=7.0)),
                       _bits(torch.nan_to_num(a, nan=7.0)))
    assert ell.idx.dtype == torch.int32 and ell.val.dtype == a.dtype
    assert ell.n_rows == a.shape[0]


@pytest.mark.parametrize("case", ["simult", "onebd", "sparse"])
def test_ell_width_is_the_operators_widest_column(case):
    """The width is the largest count of nonzeros in a column; each
    column's rows ascend; padding is value 0 at the column's last row (row
    0 where the column has none)."""
    a = (_sparse_operator() if case == "sparse"
         else _grid(case, "cpu")[1].a_matrix)
    ell = ell_pack(a)
    nonzero = (a != 0)
    counts = nonzero.sum(0)
    assert ell.idx.shape == (int(counts.max()), a.shape[1])
    for c in range(a.shape[1]):
        n = int(counts[c])
        rows = ell.idx[:, c].long()
        assert torch.equal(rows[:n], torch.nonzero(nonzero[:, c])[:, 0])
        assert bool(torch.all(ell.val[n:, c] == 0))
        pad = rows[n - 1] if n else 0
        assert bool(torch.all(rows[n:] == pad))
    if case == "sparse":
        assert ell.idx.shape[0] == 12 and int((counts == 0).sum()) == 2
    if case == "onebd":
        assert int((counts == 0).sum()) > 0


def test_empty_operator_packs_to_width_zero():
    ell = ell_pack(torch.zeros((8, 5)))
    assert ell.idx.shape == (0, 5) and ell.val.shape == (0, 5)


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_gather_over_the_packing_is_the_dense_product(model):
    """A float64 gather over the packed entries, in their order, against
    the dense float64 product of the same float32 values: the packing
    carries the operator's whole product (16 walkers' counts moments)."""
    spec, grid = _grid(model, "cpu")
    x = _moments(spec, grid, model, 16, seed=5).double()
    ell = ell_pack(grid.a_matrix)
    gathered = (x[:, ell.idx.long()] * ell.val.double()).sum(1)
    want = x @ grid.a_matrix.double()
    scale = (x.abs() @ grid.a_matrix.double().abs())
    assert bool(torch.all((gathered - want).abs() <= 1e-12 * scale))


def test_grid_packs_once_and_not_as_a_buffer():
    """``E0Grid.ell`` packs once per device; the packing is no buffer, so
    ``float64()`` neither widens nor copies it."""
    _, grid = _grid("simult", "cpu")
    names = {name for name, _ in grid.named_buffers()}
    first = grid.ell()
    assert grid.ell() is first
    assert {name for name, _ in grid.named_buffers()} == names
    wide = grid.float64()
    assert {name for name, _ in wide.named_buffers()} == names
    assert "_ell" not in wide.__dict__
    assert first.idx.dtype == torch.int32
    assert first.val.dtype == torch.float32


@pytest.mark.parametrize("kind", ["float32", "float64", "grad"])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_contract_takes_the_dense_product_off_the_card(model, kind):
    """On the CPU, in float32 and float64 and under a gradient: the dense
    product of ``rowwise_matmul`` bit for bit, no launch."""
    spec, grid = _grid(model, "cpu")
    x = _moments(spec, grid, model, 16, seed=9)
    if kind == "float64":
        grid, x = grid.float64(), x.double()
    if kind == "grad":
        x.requires_grad_(True)
    launches = a_contract.launches
    got = contract(grid, x.reshape(-1, 4, grid.n_fine))
    want = rowwise_matmul(x, grid.a_matrix)
    assert a_contract.launches == launches
    assert got.shape == (x.shape[0], grid.n_x, grid.n_ed)
    assert torch.equal(got.detach().reshape(x.shape[0], -1), want.detach())
    assert got.requires_grad == (kind == "grad")


def test_wrapper_refuses_a_device_without_the_kernel():
    """No plain fallback inside the wrapper: the CPU and the meta device
    have no kernel."""
    ell = ell_pack(_sparse_operator())
    launches = a_contract.launches
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="no kernel"):
            a_contract(torch.zeros((2, 12), device=device), ell)
    assert a_contract.launches == launches


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _within_fma_bound(got, x, a):
    """The kernel against the float64 product of the same float32 values:
    each output within (n + 1) float32 ulps of its absolute sum |x| @ |A|,
    n its column's nonzeros (the error bound of a chain of n fmaf), and
    the largest gap in those ulps."""
    scale = x.double().abs() @ a.double().abs()
    gap = (got.double() - x.double() @ a.double()).abs()
    terms = (a != 0).sum(0).double() + 1.0
    ok = bool(torch.all(gap <= terms * 2.0 ** -24 * scale))
    ulps = torch.where(scale > 0, gap / (2.0 ** -24 * scale), gap)
    return ok, ulps.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 37, 384, 512])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_kernel_against_the_dense_product(dev, model, n_rows):
    """The presets' A at 200k draws (simultFit float32, oneBD hardcore
    rounded to bfloat16) on the counts path's moments: every output within
    the fmaf chain's error bound of the exact product, as the dense product
    of ``rowwise_matmul`` is; one launch.  Whether the bits equal the dense
    product's is printed (oneBD's SGEMM adds in the kernel's order,
    simultFit's splits the sum over k)."""
    spec, grid = _grid(model, dev, 200_000, fine_grid=None)
    x = _moments(spec, grid, model, 172, seed=n_rows)[:n_rows]
    launches = a_contract.launches
    got = contract(grid, x.reshape(-1, 4, grid.n_fine))
    assert a_contract.launches == launches + 1
    got = got.reshape(n_rows, -1)
    want = rowwise_matmul(x, grid.a_matrix)
    torch.cuda.synchronize()
    ok, ulps = _within_fma_bound(got, x, grid.a_matrix)
    dense_ok, dense_ulps = _within_fma_bound(want, x, grid.a_matrix)
    print(f"a_contract {model} at {n_rows} rows: at most {ulps:.3f} ulps of "
          f"an output's absolute sum from the exact product (dense "
          f"{dense_ulps:.3f}); bits equal to the dense product: "
          f"{torch.equal(_bits(got), _bits(want))}")
    assert ok and dense_ok


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_a_row_is_the_same_bits_in_every_batch(dev, model):
    """A row's result alone, in the whole batch, in a shuffled half and in
    a batch of 37: the same bits."""
    spec, grid = _grid(model, dev, 200_000, fine_grid=None)
    x = _moments(spec, grid, model, 128, seed=3)
    ell = grid.ell()
    whole = a_contract(x, ell)
    perm = torch.randperm(x.shape[0], generator=torch.Generator()
                          .manual_seed(1)).to(dev)[:x.shape[0] // 2]
    assert torch.equal(_bits(a_contract(x[perm], ell)), _bits(whole[perm]))
    assert torch.equal(_bits(a_contract(x[5:42], ell)), _bits(whole[5:42]))
    for r in (0, 77, x.shape[0] - 1):
        assert torch.equal(_bits(a_contract(x[r:r + 1], ell)),
                           _bits(whole[r:r + 1]))


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph(dev):
    """Captured once, replayed on new rows copied into the captured input:
    the eager bits; the capture counts one launch, replays none."""
    spec, grid = _grid("onebd", dev, 200_000, fine_grid=None)
    x = _moments(spec, grid, "onebd", 128, seed=4)
    y = _moments(spec, grid, "onebd", 128, seed=6)
    ell = grid.ell()
    static = x.clone()
    a_contract(static, ell)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    launches = a_contract.launches
    with torch.cuda.graph(graph):
        out = contract(grid, static.reshape(-1, 4, grid.n_fine))
    assert a_contract.launches == launches + 1
    for rows in (x, y):
        static.copy_(rows)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out.reshape(rows.shape[0], -1)),
                           _bits(a_contract(rows, ell)))
    assert a_contract.launches == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float64", "grad"])
def test_float64_and_gradients_take_the_dense_product_on_the_card(dev,
                                                                   kind):
    """No launch for a float64 grid or moments that need a gradient: the
    dense product, bit for bit ``rowwise_matmul``'s."""
    spec, grid = _grid("simult", dev, 200_000, fine_grid=None)
    x = _moments(spec, grid, "simult", 16, seed=2)
    if kind == "float64":
        grid, x = grid.float64(), x.double()
    else:
        x.requires_grad_(True)
    launches = a_contract.launches
    got = contract(grid, x.reshape(-1, 4, grid.n_fine))
    assert a_contract.launches == launches
    want = rowwise_matmul(x, grid.a_matrix)
    assert torch.equal(got.detach().reshape(x.shape[0], -1), want.detach())
    assert got.requires_grad == (kind == "grad")


@pytest.mark.cuda
def test_kernel_beyond_four_staged_rows_and_empty_batches(dev):
    """oneBD at F = 4,096 (a 64 KB row: one row a block) against the dense
    product, and a batch of no rows."""
    spec, grid = _grid("onebd", dev, 200_000, fine_grid=4096)
    x = _moments(spec, grid, "onebd", 8, seed=8)
    got = a_contract(x, grid.ell())
    assert _within_fma_bound(got, x, grid.a_matrix)[0]
    empty = contract(grid, x[:0].reshape(0, 4, grid.n_fine))
    assert empty.shape == (0, grid.n_x, grid.n_ed)


@pytest.mark.cuda
def test_a_moved_grid_packs_again(dev):
    """A grid moved to another device (here: to the card, from the CPU)
    packs its operator there at its first contraction."""
    spec, grid = _grid("simult", "cpu", 200_000, fine_grid=None)
    cpu_ell = grid.ell()
    grid = grid.to(dev)
    packed = grid.ell()
    assert packed.idx.device == dev and grid.ell() is packed
    assert torch.equal(packed.idx.cpu(), cpu_ell.idx)
    assert torch.equal(packed.val.cpu(), cpu_ell.val)
