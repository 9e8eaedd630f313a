"""Matrix products whose rows do not depend on the batch.

On the card this serves the timing convolutions
(``ops/timing.apply_same_matrix``); the A contraction of the e0grid
estimators (``ops/e0grid.contract``) comes here only on the CPU, in
float64 or under a gradient, its float32 product on the card being the
row-independent kernel of ``ops/cuda_contract.py``.  The products go in
blocks of one shape, ``ROWS`` rows each, the last block padded with
zeros.  One product over all n rows does not give a row the same bits for
every n: cuBLAS picks its algorithm by the row count, and on an H100 the
rows of a 512-row and of a 256-row product differ in their last bits
(``perf/shard_bits.py``).  A shard of the walkers (``parallel/mesh.py``)
would see them, ``rint`` turning a grid's last bits into whole draws.
"""
from __future__ import annotations

import torch

# rows per product: the simultFit half-step's 128 walkers x 4 runs on the
# card, one product; small blocks on the CPU
ROWS = {"cuda": 512, "cpu": 64}


def rowwise_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x (n, K) @ a (K, N), every row's result independent of n."""
    block = ROWS.get(x.device.type, ROWS["cpu"])
    n = x.shape[0]
    if n % block:
        x = torch.nn.functional.pad(x, (0, 0, 0, -n % block))
    if x.shape[0] == block:
        return (x @ a)[:n]
    return torch.cat([x[i:i + block] @ a
                      for i in range(0, x.shape[0], block)])[:n]
