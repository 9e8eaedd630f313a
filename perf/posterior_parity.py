"""The port's side of its posterior parity with the JAX package.

Reads a case's reference (``perf/parity/<case>.npz`` + ``.json``, made on
the CPU by ``perf/parity_reference.py``), builds the port's problem on
the JAX package's observed arrays and writes ``<case>_port.json`` beside
it:

* density: the port's log-prob at the reference's thetas, ``repeats``
  times each, through ``JointFitProblem.make_log_prob_fn`` with one
  explicit host generator; for 'expected' its value and autograd
  gradient.  Gated by ``utils/parity.py`` (``density_parity`` /
  ``expected_parity``);
* chain (the counts cases): the port's DE chain at the reference's
  walkers, burn-in and main steps, from its own
  ``initial_walkers_from_observed``, gated by ``dz_table`` against the JAX
  chain's summary;
* NUTS (``simult_expected``): the port's ``nuts_sample`` in box-logit
  coordinates, mapped back and gated by ``dz_table`` against the JAX DE
  chain on the same posterior, and by its ESS from the spread of its
  independent chains' means (``parity.between_chain_ess``) >=
  ``NUTS_MIN_ESS``; divergences counted;
* the chi-square gate's strength (the counts cases): the gate at the
  thetas with their first parameter moved by ``SHIFT_LADDER`` posterior
  sigmas; the dz tables of the JAX package's other chains of the case
  (``<case>_seed<N>.json``) and, with ``--replicates N``, of the port's
  chains at more seeds, against the JAX chain and each other.

Each file ends with PASS or REVIEW per gate, the card's name and power
limit (``nvidia-smi``) and the wall-clock seconds.  No JAX: on the card,

    python perf/posterior_parity.py                    # every case, cuda
    python perf/posterior_parity.py simult_counts --device cpu --no-chain

The whole set takes ~35 min on an H100 with ``--replicates 3`` (NUTS 24
of it, oneBD's chains 1.5 min each).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mcmctoffitting_tpu_torch.sampler import nuts_sample  # noqa: E402
from mcmctoffitting_tpu_torch.sampler.transforms import (  # noqa: E402
    BoxLogitTransform)
from mcmctoffitting_tpu_torch.utils import parity  # noqa: E402
from mcmctoffitting_tpu_torch.utils.diagnostics import (  # noqa: E402
    effective_sample_size, split_rhat)

REF_DIR = REPO / "perf" / "parity"
# 1,024 chains x (300 warm-up + 100) transitions at depth 8: a transition
# costs ~3.6 s on an H100 (host-bound, every batch near the full depth)
# whatever the chain count, and the ESS from the spread of the chains'
# means grows with the chains (256 x 50 gave 264); after 200 warm-up
# transitions s had not yet spread to its stationary width (ESS 3,327,
# split R-hat 1.55), after 300 it had (29,591, 1.03)
NUTS_CHAINS, NUTS_WARMUP, NUTS_STEPS, NUTS_DEPTH = 1024, 300, 100, 8
NUTS_MIN_ESS = 1000.0
# shifts of the first parameter, in its posterior sigma, for the chi-square
# gate's strength
SHIFT_LADDER = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(torch.device(device))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_nuts(ref, problem, *, chains=NUTS_CHAINS, warmup=NUTS_WARMUP,
             steps=NUTS_STEPS, max_depth=NUTS_DEPTH, seed=0):
    """NUTS on the case's posterior in box-logit coordinates: (chain
    (S, C, D) in theta, info)."""
    dev = problem.device
    logp = problem.make_log_prob_fn(ref.observed)
    eval_gen = torch.Generator()          # 'expected' draws nothing
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi, device=dev)
    logp_u = tr.wrap_logp(lambda theta: logp(theta, eval_gen))
    gen = torch.Generator(dev).manual_seed(seed)
    cloud = problem.initial_walkers_from_observed(gen, chains, ref.observed)
    out = nuts_sample(gen, tr.to_u(cloud), steps, logp_u, n_warmup=warmup,
                      max_depth=max_depth)
    chain = tr.to_theta(out.positions).double().cpu().numpy()
    info = {"chains": chains, "warmup": warmup, "steps": steps,
            "max_depth": max_depth, "step_size": out.step_size,
            "divergences": int(out.diverging.sum()),
            "transitions": int(out.diverging.numel()),
            "mean_tree_depth": float(out.tree_depth.float().mean()),
            "accept_stat": float(out.accept_stat.mean()),
            "gradient_evaluations": out.n_grad_evals,
            "min_ess": float(effective_sample_size(chain).min()),
            "ess_between_chains": parity.between_chain_ess(chain).tolist(),
            "min_ess_between_chains": float(
                parity.between_chain_ess(chain).min()),
            "split_rhat": split_rhat(chain).tolist(),
            # pooled sd of the second half of the kept transitions over
            # the first half's: above 1, the chains were still spreading
            # out (and the ESS from their means overstated)
            "width_ratio_halves": (
                chain[steps - steps // 2:].reshape(-1, chain.shape[2]).std(0)
                / chain[:steps // 2].reshape(-1, chain.shape[2]).std(0)
            ).tolist()}
    return chain, info


def gate_ladder(ref, problem, seed):
    """The chi-square gate against the same JAX values at the thetas
    shifted by each of ``SHIFT_LADDER`` (posterior sigmas of the first
    parameter, towards the box's middle): chi2/dof per shift and the
    smallest shift the gate catches."""
    rows = []
    for k in SHIFT_LADDER:
        dens = parity.density_check(ref, problem, seed=seed + 1,
                                    thetas=parity.shifted_thetas(
                                        ref, problem, k))
        rows.append({"shift_sigma": k, "chi2_dof": dens["chi2_dof"],
                     "spread_nats": dens["spread_nats"],
                     "chi2_verdict": dens["chi2_verdict"],
                     "spread_verdict": dens["spread_verdict"]})
    caught = [r["shift_sigma"] for r in rows if r["chi2_verdict"] != "PASS"]
    return {"parameter": ref.names[0], "ladder": rows,
            "smallest_caught_sigma": min(caught) if caught else None}


def chain_replicates(ref, problem, seed, n, first):
    """The port's chain again with seeds seed + 1 .. seed + n - 1: each
    one's dz table against the JAX chain and against the port's first
    chain (``first``, its summary): the port's own chain-to-chain
    spread beside its distance from the JAX package."""
    out = []
    for k in range(1, n):
        pos, acc = parity.run_port_chain(ref, problem, seed=seed + k)
        summ = parity.chain_summary(pos, ref.names)
        out.append({"seed": seed + k, "acceptance": acc,
                    "against_jax": parity.dz_between(
                        ref.meta["chain"]["summary"], summ, ref.names),
                    "against_port_seed": parity.dz_between(
                        first, summ, ref.names)})
    return out


def jax_replicates(ref, ref_dir, name, port):
    """The dz tables of the JAX package's other chains of the case
    (``<case>_seed<N>.json``, ``perf/parity_reference.py --replicate``)
    against its reference chain and against the port's first chain
    (``port``, its summary): how far two JAX chains are apart, and
    whether the reference or the port is the odd one."""
    out = []
    for path in sorted(ref_dir.glob(f"{name}_seed*.json")):
        other = json.loads(path.read_text())
        out.append({"seed": other["seed"], "burnin": other["burnin"],
                    "main": other["main"],
                    "acceptance": other["acceptance"],
                    "against_jax": parity.dz_between(
                        ref.meta["chain"]["summary"], other["summary"],
                        ref.names),
                    "against_port_seed": parity.dz_between(
                        port, other["summary"], ref.names)})
    return out


def run_case(name, device, *, ref_dir=REF_DIR, seed=0, chain=True,
             thetas=None, replicates=1):
    """One case's port side: the result dict (what ``<case>_port.json``
    holds).  ``chain``: run the counts chains, NUTS on 'expected' and
    :func:`gate_ladder`, or the density check alone; ``thetas``: evaluate
    there instead of at the reference's thetas (against the same
    reference values); ``replicates``: the counts chains that many times
    (:func:`chain_replicates`)."""
    ref = parity.load_reference(Path(ref_dir) / f"{name}.npz")
    problem = parity.build_problem(ref.meta, device)
    result = {"case": name, "device": card_line(device),
              "torch": torch.__version__, "sampling": ref.meta["sampling"],
              "n_runs": ref.meta["n_runs"], "n_draws": ref.meta["n_draws"],
              "fine_grid": problem.spec.e0_grid_fine}
    verdicts = {}
    t0 = time.perf_counter()
    dens = parity.density_check(ref, problem, seed=seed, thetas=thetas)
    _sync(device)
    dens["seconds"] = time.perf_counter() - t0
    result["density"] = dens
    verdicts["density"] = dens["verdict"]
    if chain and name in parity.DE_CHAIN_CASES:
        t0 = time.perf_counter()
        pos, acc = parity.run_port_chain(ref, problem, seed=seed)
        table = parity.dz_table(ref.meta["chain"]["summary"], pos, ref.names)
        table.update(acceptance=acc, ref_acceptance=ref.meta["chain"]
                     ["acceptance"], seconds=time.perf_counter() - t0,
                     walkers=ref.meta["chain"]["walkers"],
                     burnin=ref.meta["chain"]["burnin"],
                     main=ref.meta["chain"]["main"])
        result["chain"] = table
        verdicts["chain"] = table["verdict"]
        port = parity.chain_summary(pos, ref.names)
        result["jax_replicates"] = jax_replicates(ref, Path(ref_dir), name,
                                                  port)
        if replicates > 1:
            result["chain_replicates"] = chain_replicates(
                ref, problem, seed, replicates, port)
        result["gate_strength"] = gate_ladder(ref, problem, seed)
    if chain and ref.meta["sampling"] == "expected":
        t0 = time.perf_counter()
        pos, info = run_nuts(ref, problem, seed=seed)
        table = parity.dz_table(ref.meta["chain"]["summary"], pos, ref.names)
        table.update(info, seconds=time.perf_counter() - t0)
        result["nuts"] = table
        verdicts["nuts"] = table["verdict"]
        verdicts["nuts_ess"] = ("PASS" if info["min_ess_between_chains"]
                                >= NUTS_MIN_ESS else "REVIEW")
    result["verdicts"] = verdicts
    result["verdict"] = ("PASS" if all(v == "PASS" for v in verdicts.values())
                         else "REVIEW")
    return result


def summary_line(result) -> str:
    d = result["density"]
    parts = [f"{result['case']}: density spread {d['spread_nats']:.3f} nats"]
    if "chi2_dof" in d:
        parts.append(f"chi2/dof {d['chi2_dof']:.3f} (<= "
                     f"{d['chi2_dof_max']:.3f}), noise {d['noise_nats']:.3f}")
    else:
        parts.append(f"(< {d['spread_tol_nats']}), grad rel L2 max "
                     f"{d.get('grad_rel_l2_max', float('nan')):.2e} (< "
                     f"{d.get('grad_tol', float('nan'))}), median "
                     f"{d.get('grad_rel_l2_median', float('nan')):.2e} (< "
                     f"{d.get('grad_median_tol', float('nan'))})")
    for key in ("chain", "nuts"):
        if key in result:
            t = result[key]
            parts.append(f"{key} worst |dz| {t['worst_dz']:.3f}, worst "
                         f"|z_se| {t['worst_z_se']:.2f}, min ESS port "
                         f"{t['min_port_ess']:.0f} / JAX "
                         f"{t['min_ref_ess']:.0f}")
    if "nuts" in result:
        nuts = result["nuts"]
        parts.append(f"NUTS ESS from its chains' means "
                     f"{nuts['min_ess_between_chains']:.0f} (>= "
                     f"{NUTS_MIN_ESS:.0f}), split R-hat max "
                     f"{max(nuts['split_rhat']):.3f}, width ratio of the "
                     f"halves {min(nuts['width_ratio_halves']):.3f}-"
                     f"{max(nuts['width_ratio_halves']):.3f}")
    if "gate_strength" in result:
        g = result["gate_strength"]
        parts.append(f"the chi-square gate catches {g['parameter']} "
                     f"shifted by {g['smallest_caught_sigma']} sigma")
    parts.append(f"-> {result['verdict']} {result['verdicts']}")
    return ", ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=list(parity.CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ref-dir", default=str(REF_DIR))
    ap.add_argument("--out-dir", default=None,
                    help="where <case>_port.json goes (default: --ref-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-chain", action="store_true",
                    help="density only: no DE chain, no NUTS, no shifts")
    ap.add_argument("--replicates", type=int, default=1,
                    help="run each counts chain this many times (seeds "
                    "--seed and up) and compare the port's chains with "
                    "each other too")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir or args.ref_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True
    for name in args.cases:
        t0 = time.perf_counter()
        result = run_case(name, args.device, ref_dir=args.ref_dir,
                          seed=args.seed, chain=not args.no_chain,
                          replicates=args.replicates)
        result["seconds"] = time.perf_counter() - t0
        (out_dir / f"{name}_port.json").write_text(
            json.dumps(result, indent=1) + "\n")
        print(summary_line(result), flush=True)
        for key in ("chain", "nuts"):
            if key in result:
                print(parity.format_dz(result[key]), flush=True)
        for rep in result.get("jax_replicates", ()):
            other = f"JAX s{rep['seed']}"
            print(f"the JAX package's seed {rep['seed']} against its "
                  "reference chain and the port's:\n"
                  + parity.format_dz(rep["against_jax"], ("JAX", other))
                  + "\n" + parity.format_dz(rep["against_port_seed"],
                                            (f"port s{args.seed}", other)),
                  flush=True)
        for rep in result.get("chain_replicates", ()):
            port = f"port s{rep['seed']}"
            print(f"the port's seed {rep['seed']}:\n"
                  + parity.format_dz(rep["against_jax"], ("JAX", port))
                  + "\n" + parity.format_dz(rep["against_port_seed"],
                                            (f"port s{args.seed}", port)),
                  flush=True)
        ok = ok and result["verdict"] == "PASS"
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
