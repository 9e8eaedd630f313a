"""What the benchmark loads: nothing whose top-level name is a JAX
library or the JAX package (the port's name starts with the JAX
package's, so names are compared whole), and a reference that loads no
part of the program."""
import json
import subprocess
import sys

from portbench.plan import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mcmctoffitting_tpu"}

HARNESS = """
import json, sys, time
sys.path.insert(0, '.')
import torch
from portbench import harness, plan as plans, control
p = plans.resolve('simult-counts', plans.benchmark(plans.ROOT))
p.config = dict(p.config, n_samples=4000, n_runs=1,
                truth=p.config['truth'][:5],
                agitators=p.config['agitators'][:5])
p.traffic = dict(p.traffic, walkers=8, segment_steps=1,
                 check_evaluations=2)
for m in p.per_layer:
    plans.metric_reader(m['name'])
harness.run(p, 3, 0.2, True, t_start=time.perf_counter(), device='cpu',
            log=lambda s: None)
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, '.')
from portbench.reference import counts, de_move, forward, poisson, tables
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""


def _top_level(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level(HARNESS)
    assert "mcmctoffitting_tpu_torch" in names     # the program ran
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"mcmctoffitting_tpu_torch"})
