"""Box-logit reparameterisation for the gradient samplers.

Port of ``mcmctoffitting_tpu/sampler/transforms.py``.  The flagship
posteriors live on a box prior; in linear coordinates a leapfrog step
that crosses a face lands on log p = -inf.  The samplers therefore run in
unconstrained u in R^D with

    theta(u)   = lo + (hi - lo) * sigmoid(u)
    log|J|(u)  = sum_d [ log(hi_d - lo_d) + log_sigmoid(u_d)
                         + log_sigmoid(-u_d) ]

so that the box posterior becomes a smooth density on all of R^D (the
Jacobian term takes the place of the flat box prior).  Every function
takes a batch of points over the leading axes, ``(..., D)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.forward import resolve_device


class BoxLogitTransform:
    """u in R^D <-> theta in (lo, hi), with the exact log-Jacobian.  The
    bounds are float32 tensors on ``device``: the GPU unless the caller
    asks for the CPU."""

    def __init__(self, lo, hi, *, device="cuda"):
        device = resolve_device(device)
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        if not np.all(hi > lo):
            raise ValueError("box bounds must satisfy hi > lo elementwise")
        self.lo = torch.as_tensor(lo, device=device)
        self.hi = torch.as_tensor(hi, device=device)
        self.width = torch.as_tensor(hi - lo, device=device)
        self._log_width_sum = float(np.sum(np.log(hi - lo)))

    def to_theta(self, u: torch.Tensor) -> torch.Tensor:
        return self.lo + self.width * torch.sigmoid(u)

    def log_det_jacobian(self, u: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (...)."""
        return self._log_width_sum + torch.sum(
            F.logsigmoid(u) + F.logsigmoid(-u), dim=-1)

    def to_u(self, theta, *, eps: float = 1e-5) -> torch.Tensor:
        """Inverse (for initial positions); clips into the open box so that
        points exactly on a face map to finite u."""
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=self.lo.device)
        p = torch.clamp((theta - self.lo) / self.width, eps, 1.0 - eps)
        return torch.log(p) - torch.log1p(-p)

    def wrap_logp(self, logp_theta):
        """log p over u for a batched log p over theta, (C, D) -> (C,)."""
        def logp_u(u):
            return logp_theta(self.to_theta(u)) + self.log_det_jacobian(u)
        return logp_u
