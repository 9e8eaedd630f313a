"""The port's side of its posterior parity with the JAX package.

Reads a case's reference (``perf/parity/<case>.npz`` + ``.json``, made on
the CPU by ``perf/parity_reference.py``), builds the port's problem on
the JAX package's observed arrays and writes ``<case>_port.json`` beside
it:

* density: the port's log-prob at the reference's thetas, ``repeats``
  times each, through ``make_log_prob_fn`` with one explicit host
  generator; for 'expected' its value and autograd gradient.  Gated by
  ``utils/parity.py`` (``density_parity`` on the finite repeats and
  ``neg_inf_shares`` / ``expected_parity``);
* chain (the DE chain cases): the port's DE chain at the reference's
  walkers, burn-in and main steps, from its own initial walkers, gated by
  ``dz_table`` against the JAX chain's summary (z_se on the batch-median
  SE);
* NUTS and HMC (``simult_expected``): the port's ``nuts_sample`` and
  ``hmc_sample`` (the flagship CLIs' settings) in box-logit coordinates,
  mapped back and gated by ``dz_table`` against the JAX DE chain on the
  same posterior, and by their ESS from the spread of their independent
  chains' means (``parity.between_chain_ess``) >= ``GRAD_MIN_ESS``;
  divergences counted;
* the chi-square gate's strength (the DE chain cases): the gate at the
  thetas with their first parameter moved by ``SHIFT_LADDER`` posterior
  sigmas; the dz tables of the JAX package's other chains of the case
  (``<case>_seed<N>.json``) and, with ``--replicates N``, of the port's
  chains at more seeds, against the JAX chain and each other;
* evidence (``parity.PT_CASES``): the port's parallel tempering of
  ``cli/shifting_gaussian.py`` on the JAX package's data, ln Z from the
  case's number of seeds against the JAX seeds' (``evidence_parity``),
  and the pooled cold chains' dz table.

Each file ends with PASS or REVIEW per gate, the card's name and power
limit (``nvidia-smi``) and the wall-clock seconds.  No JAX: on the card,

    python perf/posterior_parity.py                    # every case, cuda
    python perf/posterior_parity.py simult_counts --device cpu --no-chain
    python perf/posterior_parity.py --reach     # the chain gate's reach

On an H100 NUTS takes ~24 min, HMC ~2 and again ~2 at the JAX run's
settings, oneBD's chains 1.5 min each, PT analytic ~1 min a seed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mcmctoffitting_tpu_torch.sampler import (hmc_sample,  # noqa: E402
                                              nuts_sample)
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
# HMC: the flagship CLIs' -nBurninSteps (400) and hmc_sample's defaults
# (16 leapfrog steps jittered by 20%, target acceptance 0.8)
HMC_CHAINS, HMC_WARMUP, HMC_STEPS = 1024, 400, 200
# both gradient samplers: the ESS from the spread of their chains' means,
# at least GRAD_MIN_ESS and GRAD_ESS_PER_CHAIN per chain (chains that do
# not move read about one a chain: the spread of their means is that of
# their starts)
GRAD_MIN_ESS = 1000.0
GRAD_ESS_PER_CHAIN = 2.0
# two HMC runs compare as posteriors only once both have mixed: split
# R-hat below this on every parameter (Gelman et al., BDA3, 11.4)
RHAT_MIXED = 1.1
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


def _box_logit_start(observed, problem, chains, seed, cloud=None):
    """The gradient samplers' start, as ``cli/_driver.py::
    run_gradient_sampler`` makes it (or ``cloud``, (C, D) thetas): (
    generator, transform, log-prob in box-logit coordinates, initial
    positions there)."""
    dev = problem.device
    logp = problem.make_log_prob_fn(observed)
    eval_gen = torch.Generator()          # 'expected' draws nothing
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi, device=dev)
    logp_u = tr.wrap_logp(lambda theta: logp(theta, eval_gen))
    gen = torch.Generator(dev).manual_seed(seed)
    if cloud is None:
        cloud = problem.initial_walkers_from_observed(gen, chains, observed)
    else:
        cloud = torch.as_tensor(np.array(cloud, np.float32), device=dev)
    return gen, tr, logp_u, tr.to_u(cloud)


def _chains_info(chain, chains, warmup, steps) -> dict:
    """Mixing diagnostics of C independent chains, (S, C, D) in theta."""
    ess = parity.between_chain_ess(chain)
    return {"chains": chains, "warmup": warmup, "steps": steps,
            "min_ess": float(effective_sample_size(chain).min()),
            "ess_between_chains": ess.tolist(),
            "min_ess_between_chains": float(ess.min()),
            "split_rhat": split_rhat(chain).tolist(),
            # pooled sd of the second half of the kept transitions over
            # the first half's: above 1, the chains were still spreading
            # out (and the ESS from their means overstated)
            "width_ratio_halves": (
                chain[steps - steps // 2:].reshape(-1, chain.shape[2]).std(0)
                / chain[:steps // 2].reshape(-1, chain.shape[2]).std(0)
            ).tolist()}


def run_nuts(ref, problem, *, chains=NUTS_CHAINS, warmup=NUTS_WARMUP,
             steps=NUTS_STEPS, max_depth=NUTS_DEPTH, seed=0):
    """NUTS on the case's posterior in box-logit coordinates: (chain
    (S, C, D) in theta, info)."""
    gen, tr, logp_u, p0 = _box_logit_start(ref.observed, problem, chains,
                                           seed)
    out = nuts_sample(gen, p0, steps, logp_u, n_warmup=warmup,
                      max_depth=max_depth)
    chain = tr.to_theta(out.positions).double().cpu().numpy()
    info = _chains_info(chain, chains, warmup, steps)
    info.update(max_depth=max_depth, step_size=out.step_size,
                divergences=int(out.diverging.sum()),
                transitions=int(out.diverging.numel()),
                mean_tree_depth=float(out.tree_depth.float().mean()),
                accept_stat=float(out.accept_stat.mean()),
                gradient_evaluations=out.n_grad_evals)
    return chain, info


def run_hmc(ref, problem, *, chains=HMC_CHAINS, warmup=HMC_WARMUP,
            steps=HMC_STEPS, seed=0, observed=None, cloud=None):
    """HMC on the case's posterior in box-logit coordinates, as
    ``cli/_driver.py::run_gradient_sampler`` runs it (from ``cloud``,
    (C, D) thetas, where given; ``observed`` in place of the
    reference's): (chain (S, C, D) in theta, info)."""
    observed = ref.observed if observed is None else observed
    gen, tr, logp_u, p0 = _box_logit_start(observed, problem, chains, seed,
                                           cloud)
    out = hmc_sample(gen, p0, steps, logp_u, n_warmup=warmup)
    chain = tr.to_theta(out.positions).double().cpu().numpy()
    info = _chains_info(chain, chains, warmup, steps)
    info.update(step_size=out.step_size,
                accept_prob=float(out.accept_prob.mean()),
                gradient_evaluations=out.n_grad_evals)
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


def hmc_against_jax(ref, problem, path, seed):
    """The port's HMC at the chains, warm-up and steps of the JAX
    package's HMC run (``<case>_hmc.json``, ``perf/parity_reference.py
    --hmc``): the two samplers' dz table, split R-hat side by side.
    Gated as every chain is (``dz_table``) once both runs have mixed
    (split R-hat below ``RHAT_MIXED`` on every parameter); before that
    its verdict is NOT ESTABLISHED: chains that sit near their starts
    compare two starting clouds, not two posteriors."""
    jax_hmc = json.loads(Path(path).read_text())
    t0 = time.perf_counter()
    pos, info = run_hmc(ref, problem, chains=jax_hmc["chains"],
                        warmup=jax_hmc["warmup"], steps=jax_hmc["steps"],
                        seed=seed)
    table = parity.dz_table(jax_hmc["summary"], pos, ref.names)
    table.update(info, seconds=time.perf_counter() - t0,
                 jax_split_rhat=jax_hmc["split_rhat"],
                 jax_step_size=jax_hmc["step_size"],
                 jax_accept_prob=jax_hmc["accept_prob"])
    table["mixed"] = bool(max(info["split_rhat"]) < RHAT_MIXED
                          and max(jax_hmc["split_rhat"]) < RHAT_MIXED)
    if not table["mixed"]:
        table["verdict"] = "NOT ESTABLISHED"
        table["gate"] += f", once split R-hat < {RHAT_MIXED} on both sides"
    return table


def run_evidence(name, device, *, ref_dir=REF_DIR, seed=0):
    """An evidence case's port side: the port's PT at as many seeds as the
    reference ran, from ``seed``, ln Z against the JAX seeds' and the
    pooled cold chains' dz table."""
    ref = parity.load_reference(Path(ref_dir) / f"{name}.npz")
    meta = ref.meta
    runs, colds = [], []
    for k in range(meta["seeds_run"]):
        ln_z, d_ln_z, cold, swaps, secs = parity.run_port_pt(
            meta, ref.observed, device, seed + k)
        colds.append(cold)
        runs.append({"seed": seed + k, "ln_z": ln_z, "d_ln_z": d_ln_z,
                     "swap_acceptance": swaps, "seconds": secs})
    ev = parity.evidence_parity(
        [r["ln_z"] for r in meta["runs"]], [r["ln_z"] for r in runs],
        port_var=np.var([r["ln_z"] for r in meta["runs"]], ddof=1))
    pooled = np.concatenate(colds, axis=1)
    table = parity.dz_table(meta["cold_summary"], pooled, ref.names)
    verdicts = {"ln_z": ev["verdict"], "cold_chain": table["verdict"]}
    return {"case": name, "device": card_line(device),
            "torch": torch.__version__, "runs": runs, "evidence": ev,
            "cold_chain": table, "verdicts": verdicts,
            "verdict": ("PASS" if all(v == "PASS" for v in verdicts.values())
                        else "REVIEW")}


def run_case(name, device, *, ref_dir=REF_DIR, seed=0, chain=True,
             thetas=None, replicates=1):
    """One case's port side: the result dict (what ``<case>_port.json``
    holds).  ``chain``: run the DE chains, NUTS and HMC on 'expected' and
    :func:`gate_ladder`, or the density check alone; ``thetas``: evaluate
    there instead of at the reference's thetas (against the same
    reference values); ``replicates``: the DE chains that many times
    (:func:`chain_replicates`)."""
    ref = parity.load_reference(Path(ref_dir) / f"{name}.npz")
    problem = parity.build_problem(ref.meta, device)
    result = {"case": name, "device": card_line(device),
              "torch": torch.__version__, "sampling": ref.meta["sampling"],
              "n_runs": ref.meta["n_runs"], "n_draws": ref.meta["n_draws"],
              "fine_grid": getattr(problem.spec, "e0_grid_fine", None)}
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
    gradient = chain and ref.meta["sampling"] == "expected"
    for key, run in ((("nuts", run_nuts), ("hmc", run_hmc)) if gradient
                     else ()):
        t0 = time.perf_counter()
        pos, info = run(ref, problem, seed=seed)
        table = parity.dz_table(ref.meta["chain"]["summary"], pos, ref.names)
        table.update(info, seconds=time.perf_counter() - t0)
        result[key] = table
        verdicts[key] = table["verdict"]
        need = max(GRAD_MIN_ESS, GRAD_ESS_PER_CHAIN * info["chains"])
        verdicts[f"{key}_ess"] = ("PASS" if info["min_ess_between_chains"]
                                  >= need else "REVIEW")
    jax_hmc = Path(ref_dir) / f"{name}_hmc.json"
    if gradient and jax_hmc.exists():
        result["hmc_vs_jax_hmc"] = hmc_against_jax(ref, problem, jax_hmc,
                                                   seed)
        verdicts["hmc_vs_jax_hmc"] = result["hmc_vs_jax_hmc"]["verdict"]
    result["verdicts"] = verdicts
    result["verdict"] = ("PASS" if all(v == "PASS" for v in verdicts.values())
                         else "REVIEW")
    return result


def evidence_line(result) -> str:
    ev, t = result["evidence"], result["cold_chain"]
    return (f"{result['case']}: ln Z JAX {ev['ref_mean']:.4f} (sd "
            f"{ev['ref_sd']:.4f}, {len(ev['ref_ln_z'])} seeds), port "
            f"{ev['port_mean']:.4f} (sd {ev['port_sd']:.4f}, "
            f"{len(ev['port_ln_z'])}): diff {ev['diff']:+.4f} = "
            f"{ev['z']:+.2f} noise; cold chain worst |dz| "
            f"{t['worst_dz']:.3f}, worst |z_se| {t['worst_z_se']:.2f} -> "
            f"{result['verdict']} {result['verdicts']}")


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
    if "neg_inf" in d:
        sh = d["neg_inf"]
        parts.append(f"-inf share JAX {sh['ref_share']:.4f} / port "
                     f"{sh['port_share']:.4f} (z {sh['z_pooled']:+.2f}, per "
                     f"theta {sh['z_per_theta']:.2f})")
    for key in ("chain", "nuts", "hmc"):
        if key in result:
            t = result[key]
            parts.append(f"{key} worst |dz| {t['worst_dz']:.3f}, worst "
                         f"|z_se| {t['worst_z_se']:.2f} (tool's SE "
                         f"{t['worst_z_se_tool']:.2f}), min ESS port "
                         f"{t['min_port_ess']:.0f} / JAX "
                         f"{t['min_ref_ess']:.0f}")
    for key in ("nuts", "hmc"):
        if key in result:
            g = result[key]
            parts.append(f"{key} ESS from its chains' means "
                         f"{g['min_ess_between_chains']:.0f} (>= "
                         f"{GRAD_MIN_ESS:.0f}), split R-hat max "
                         f"{max(g['split_rhat']):.3f}, width ratio of the "
                         f"halves {min(g['width_ratio_halves']):.3f}-"
                         f"{max(g['width_ratio_halves']):.3f}")
    if "gate_strength" in result:
        g = result["gate_strength"]
        parts.append(f"the chi-square gate catches {g['parameter']} "
                     f"shifted by {g['smallest_caught_sigma']} sigma")
    parts.append(f"-> {result['verdict']} {result['verdicts']}")
    return ", ".join(parts)


def print_reach(cases, ref_dir) -> None:
    """The chain gate's reach (``parity.gate_reach``) in every dz table of
    the committed ``<case>_port.json`` files: the shift of a median, in
    posterior sigmas, that the gate is sure to catch on every parameter,
    and which of dz and z_se catches it."""
    for name in cases:
        path = Path(ref_dir) / f"{name}_port.json"
        if not path.exists():
            continue
        result = json.loads(path.read_text())
        tables = [(key, result[key]) for key in
                  ("chain", "nuts", "hmc", "hmc_vs_jax_hmc", "cold_chain")
                  if key in result]
        tables = [(key, table, result["device"]) for key, table in tables]
        tables += [(f"JAX seed {rep['seed']} vs JAX", rep["against_jax"],
                    "CPU, JAX") for rep in result.get("jax_replicates", ())]
        for key, table, where in tables:
            r = parity.gate_reach(table["rows"])
            print(f"{name} {key} ({where}): catches "
                  f"{r['sigma']:.3f} sigma on every parameter, by {r['by']}; "
                  f"z_se alone {r['z_se_best_sigma']:.3f}-"
                  f"{r['z_se_sigma']:.3f} (widest on {r['widest_param']})",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*",
                    default=[*parity.CASES, *parity.PT_CASES])
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
    ap.add_argument("--reach", action="store_true",
                    help="run nothing: print the chain gate's reach in the "
                    "committed <case>_port.json files")
    args = ap.parse_args(argv)
    if args.reach:
        print_reach(args.cases, args.ref_dir)
        return 0
    out_dir = Path(args.out_dir or args.ref_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True
    for name in args.cases:
        t0 = time.perf_counter()
        if name in parity.PT_CASES:
            result = run_evidence(name, args.device, ref_dir=args.ref_dir,
                                  seed=args.seed)
        else:
            result = run_case(name, args.device, ref_dir=args.ref_dir,
                              seed=args.seed, chain=not args.no_chain,
                              replicates=args.replicates)
        result["seconds"] = time.perf_counter() - t0
        (out_dir / f"{name}_port.json").write_text(
            json.dumps(result, indent=1) + "\n")
        if name in parity.PT_CASES:
            print(evidence_line(result), flush=True)
            print(parity.format_dz(result["cold_chain"]), flush=True)
            ok = ok and result["verdict"] == "PASS"
            continue
        print(summary_line(result), flush=True)
        for key in ("chain", "nuts", "hmc", "hmc_vs_jax_hmc"):
            if key in result:
                print(f"{key}:\n" + parity.format_dz(result[key]),
                      flush=True)
        if "hmc_vs_jax_hmc" in result:
            h = result["hmc_vs_jax_hmc"]
            print(f"HMC at the JAX run's settings ({h['chains']} chains x "
                  f"{h['warmup']} + {h['steps']}): step size port "
                  f"{h['step_size']:.4g} / JAX {h['jax_step_size']:.4g}, "
                  f"acceptance {h['accept_prob']:.3f} / "
                  f"{h['jax_accept_prob']:.3f}, split R-hat max "
                  f"{max(h['split_rhat']):.3f} / "
                  f"{max(h['jax_split_rhat']):.3f}", flush=True)
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
