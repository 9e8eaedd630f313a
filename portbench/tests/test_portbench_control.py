"""The control of each cell's check, on the card at the cell's own size:
the plain reference with its matrix products in TF32 (the precision just
below the float32, TF32-off products the campaigns state), put in the
program's place, fails the cell's limits, while the program passes
them.  Skips without a card; on the card:

    python -m pytest -m cuda portbench/tests
"""
import time

import pytest
import torch

from portbench import control, harness, plan as plans
from portbench.plan import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["simult-counts", "onebd-hardcore-counts"])
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32 on the card")
    plan = plans.resolve(cell, plans.benchmark(ROOT))
    out = harness.run(plan, 4242, 3.0, False, t_start=time.perf_counter(),
                      log=lambda s: None,
                      controls={"tf32": control.tf32_reference})
    assert out["correct"], out["checks"]
    ctrl = out["controls"]["tf32"]
    assert any(ctrl[name] > limit for name, limit in plan.limits.items()
               if name in ctrl), (ctrl, plan.limits)
