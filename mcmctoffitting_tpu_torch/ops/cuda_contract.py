"""The A contraction of the e0grid estimators as a sparse gather on the card.

``csrc/a_contract.cu`` computes ``x @ A`` for the static A operator of
``ops/e0grid.py`` from A's structural nonzeros alone (0.19% of oneBD
hardcore's 4,096 x 8,000, 1.6% of simultFit's 2,048 x 500), packed once
per grid and device by :func:`ell_pack`.  Each output element is the fmaf
chain of its column's nonzeros in ascending row from +0, the order in which
a dense float32 product without split-K adds its terms; a row's result does
not depend on the other rows of the batch.

The dispatch is ``ops/e0grid.py::contract``'s, on what its input shows;
:func:`a_contract` takes float32 rows on a CUDA device that need no
gradient and raises for anything else.  ``a_contract.launches`` counts the
wrapper's calls that launch the kernel: a call made while a CUDA graph is
captured counts, and a replay of the graph, which calls no wrapper, adds
nothing (``models/logp_graph.py`` counts replays).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_build import check, current_stream_ptr, load_library


class EllOperator(NamedTuple):
    """A (K, N) operator packed as ELL by column: entry j of column c is the
    row ``idx[j, c]`` with the value ``val[j, c]``, a column's nonzeros in
    ascending row, padded to the widest column with value 0 at a row the
    column already reads (row 0 in a column with none)."""

    idx: torch.Tensor     # (width, N) int32
    val: torch.Tensor     # (width, N), A's dtype
    n_rows: int           # K


def ell_pack(a: torch.Tensor) -> EllOperator:
    """Pack a (K, N) operator's nonzeros (on its own device; ``nonzero``
    synchronises, so never inside a graph capture)."""
    k_dim, n_cols = a.shape
    cols, rows = torch.nonzero(a.t(), as_tuple=True)  # by column, then row
    counts = torch.bincount(cols, minlength=n_cols)
    width = int(counts.max()) if cols.numel() else 0
    ends = torch.cumsum(counts, 0)
    slot = torch.arange(cols.numel(), device=a.device) - (ends - counts)[cols]
    last = torch.zeros(n_cols, dtype=torch.int64, device=a.device)
    if cols.numel():
        last = torch.where(counts > 0, rows[(ends - 1).clamp_min(0)], last)
    idx = last.to(torch.int32).expand(width, n_cols).clone()
    idx[slot, cols] = rows.to(torch.int32)
    val = torch.zeros((width, n_cols), dtype=a.dtype, device=a.device)
    val[slot, cols] = a[rows, cols]
    return EllOperator(idx, val, k_dim)


def a_contract(x: torch.Tensor, ell: EllOperator) -> torch.Tensor:
    """x (n, K) float32 rows on a CUDA device, no gradient, times the
    operator ``ell`` packs: (n, N) float32, from one launch."""
    if x.device.type != "cuda":
        raise ValueError(f"a_contract: no kernel for device {x.device}")
    if x.dtype != torch.float32 or ell.val.dtype != torch.float32:
        raise TypeError(f"a_contract: the kernel takes float32, got rows "
                        f"{x.dtype} and an operator {ell.val.dtype}")
    if x.requires_grad:
        raise ValueError("a_contract: the kernel has no gradient")
    if x.dim() != 2 or x.shape[1] != ell.n_rows:
        raise ValueError(f"a_contract: rows {tuple(x.shape)} against an "
                         f"operator of {ell.n_rows} rows")
    if ell.idx.device != x.device:
        raise ValueError(f"a_contract: rows on {x.device}, the operator on "
                         f"{ell.idx.device}")
    x = x.contiguous()
    n, width, n_cols = x.shape[0], ell.idx.shape[0], ell.idx.shape[1]
    out = torch.empty((n, n_cols), dtype=torch.float32, device=x.device)
    if n and n_cols:
        check(load_library().lib.mcmctof_a_contract(
            x.data_ptr(), ell.idx.data_ptr(), ell.val.data_ptr(),
            out.data_ptr(), n, ell.n_rows, n_cols, width, x.device.index,
            current_stream_ptr(x.device)), "a_contract kernel launch")
        a_contract.launches += 1
    return out


a_contract.launches = 0
