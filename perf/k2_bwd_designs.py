"""The designs K2's backward was chosen from, timed in turns on one card.

Each design is this checkout's ``csrc/tof_hist.cu`` with one text edit,
in a copy of ``mcmctoffitting_tpu_torch`` under ``--work`` (listed in
``.gitignore``); where a text no longer appears, the script stops and says
which edit failed.  ``perf/k2_bwd_parent_check.py`` runs every design at
its three shapes, first the checkout itself with ``--save``, then each
design, then all of them again in the reverse order: each design's output
is held bit for bit against the checkout's, and its times sit beside the
checkout's from the same call.

    PYTHONPATH=. python perf/k2_bwd_designs.py \\
        [--out out/k2_bwd_designs.json] [design ...]

It also records the SASS of the checkout's own backward kernels
(``cuobjdump -sass`` of its library): per kernel, the instructions by
opcode in all and after the barrier, where the samples are.

Needs a CUDA GPU and nvcc; each copy builds its own kernel library.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "mcmctoffitting_tpu_torch/csrc/tof_hist.cu"

# name -> (what it is, [(old text, new text)])
DESIGNS = {
    "stage_by_plain_loads": (
        "the cotangent staged by loads into registers and stores to shared "
        "memory instead of cp.async",
        [('  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::'
          '"r"(to),\n               "l"(src)\n               : "memory");',
          "  *dst = *src;\n  (void)to;"),
         ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");', "")]),
    "gather_through_l1": (
        "no staging: every block gathers the cotangent from device memory "
        "through L1",
        [("sizeof(float) * layout.span * n_pad <= mcmctof::kSmemOptIn;",
          "sizeof(float) * layout.span * n_pad <= 0;")]),
    "k10_cells_2": (
        "K = 10, two cells a thread instead of five",
        [("return k == 10 ? 5 : k == 1 ? 8 : 4;",
          "return k == 10 ? 2 : k == 1 ? 8 : 4;")]),
    "k10_cells_10": (
        "K = 10, ten cells a thread instead of five",
        [("return k == 10 ? 5 : k == 1 ? 8 : 4;",
          "return k == 10 ? 10 : k == 1 ? 8 : 4;")]),
    "k1_cells_4": (
        "K = 1, four cells a thread instead of eight",
        [("return k == 10 ? 5 : k == 1 ? 8 : 4;",
          "return k == 10 ? 5 : k == 1 ? 4 : 4;")]),
    "k1_cells_16": (
        "K = 1, sixteen cells a thread instead of eight",
        [("return k == 10 ? 5 : k == 1 ? 8 : 4;",
          "return k == 10 ? 5 : k == 1 ? 16 : 4;")]),
    "gather_only_in_window": (
        "a sample gathers only where it is in the window (tof_bin, the "
        "gather and the sum under one branch) instead of every sample "
        "gathering at its clamped bin",
        [("    const int bin = tof_bin_clamped(v, lo, scale, nb1);\n"
          "    float g;\n    if constexpr (STAGE) {\n"
          "      g = load_shared(g_at + 4u * bin);\n"
          "    } else {\n      g = g_row[bin];\n    }\n"
          "    const float term = zw_k * g;\n"
          "    if (v >= lo && v <= hi) acc += term;",
          "    const int bin = tof_bin(v, lo, hi, scale, nb1);\n"
          "    if (bin >= 0) {\n"
          "      if constexpr (STAGE) {\n"
          "        acc += zw_k * load_shared(g_at + 4u * bin);\n"
          "      } else {\n"
          "        acc += zw_k * g_row[bin];\n      }\n    }")]),
    "select_the_term": (
        "the term or +0 chosen by a select (FSEL, then the sum) instead of "
        "a predicated sum (the same sums: an accumulator that starts at +0 "
        "is never -0)",
        [("    if (v >= lo && v <= hi) acc += term;",
          "    acc += v >= lo && v <= hi ? term : 0.0f;")]),
    "index_the_shared_array": (
        "the staged cotangent read as s_g[index] instead of by a volatile "
        "ld.shared (nvcc then sinks each gather into a branch of its own)",
        [("      g = load_shared(g_at + 4u * bin);",
          "      g = s_g[(g_at - static_cast<unsigned>(\n"
          "          __cvta_generic_to_shared(s_g))) / 4u + bin];")]),
    "threads_64": (
        "blocks of 64 threads instead of 128",
        [("constexpr int kBwdThreads = 128;",
          "constexpr int kBwdThreads = 64;"),
         ("constexpr int kBwdBlocksPerSm = 8;",
          "constexpr int kBwdBlocksPerSm = 16;")]),
    "threads_32": (
        "blocks of 32 threads instead of 128",
        [("constexpr int kBwdThreads = 128;",
          "constexpr int kBwdThreads = 32;"),
         ("constexpr int kBwdBlocksPerSm = 8;",
          "constexpr int kBwdBlocksPerSm = 32;")]),
    "k1_registers_32": (
        "K = 1, 32 registers a thread (16 blocks an SM) instead of 64",
        [("__launch_bounds__(kBwdThreads, kBwdBlocksPerSm)",
          "__launch_bounds__(kBwdThreads, K == 1 ? 16 : kBwdBlocksPerSm)")]),
    "k1_registers_32_cells_4": (
        "K = 1, 32 registers a thread and four cells a thread",
        [("__launch_bounds__(kBwdThreads, kBwdBlocksPerSm)",
          "__launch_bounds__(kBwdThreads, K == 1 ? 16 : kBwdBlocksPerSm)"),
         ("return k == 10 ? 5 : k == 1 ? 8 : 4;",
          "return k == 10 ? 5 : k == 1 ? 4 : 4;")]),
    "general_k_only": (
        "K never fixed at compile time: every K takes the general kernel "
        "(four cells a thread, the tables read in the segment loop)",
        [("int bwd_k(int n_seg) { return n_seg == 10 || n_seg == 1 ? n_seg "
          ": 0; }", "int bwd_k(int n_seg) { return 0; }")]),
}


def make_tree(work: Path, name: str, edits) -> Path:
    """A copy of the package with the design's edits of SOURCE."""
    tree = work / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "mcmctoffitting_tpu_torch",
                    tree / "mcmctoffitting_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / SOURCE
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k2_bwd_designs: the edit of design {name} "
                             f"no longer applies:\n{old}")
        text = text.replace(old, new)
    path.write_text(text)
    return tree


def sass_of_backward() -> dict:
    """'K = k, staged s' -> SASS instruction counts of that backward
    kernel of this checkout's library (NOPs left out): in all, and after
    its barrier (the staged kernels) by opcode."""
    sys.path.insert(0, str(ROOT))
    from mcmctoffitting_tpu_torch.ops import cuda_build
    lib = cuda_build.load_library().path
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0]
        found = re.search(r"tof_hist_bwd_kernelILi(\d+)ELb(\d)E", name)
        if not found:
            continue
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", block)]
        ops = [op for op in ops if op != "NOP"]
        bar = next((i for i, op in enumerate(ops)
                    if op.startswith("BAR.")), None)
        after = Counter(op.split(".")[0] for op in ops[bar + 1:]) \
            if bar is not None else None
        out[f"K = {found.group(1)}, staged {found.group(2) == '1'}"] = {
            "instructions": len(ops),
            "after_barrier": sum(after.values()) if after else None,
            "after_barrier_by_opcode": dict(after.most_common())
            if after else None}
    return out


def run(root: Path, label: str, out: Path, save: bool) -> dict:
    cmd = [sys.executable, str(ROOT / "perf" / "k2_bwd_parent_check.py"),
           "--root", str(root), "--label", label, "--out", str(out)]
    proc = subprocess.run(cmd + (["--save"] if save else []),
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"k2_bwd_designs: {label} failed:\n{proc.stdout}"
                         f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--work", default="build/k2_bwd_designs")
    p.add_argument("--out", default="out/k2_bwd_designs.json")
    p.add_argument("names", nargs="*",
                   help=f"designs to run (default: all): {', '.join(DESIGNS)}")
    args = p.parse_args()
    names = args.names or list(DESIGNS)
    if set(names) - set(DESIGNS):
        p.error(f"no design {sorted(set(names) - set(DESIGNS))}")
    work = Path(args.work).resolve()
    trees = {name: make_tree(work, name, DESIGNS[name][1])
             for name in names}
    outputs = work / "outputs"
    runs = [run(ROOT, "chosen", outputs, save=True)]
    order = ["chosen"] + names
    for name in order[1:] + order[::-1]:
        runs.append(run(ROOT if name == "chosen" else trees[name], name,
                        outputs, save=False))
    summary = {}
    for r in runs:
        for shape in ("simult", "onebd", "templates"):
            summary.setdefault(r["label"], {}).setdefault(shape, []).append(
                {"ms": r[shape]["ms"],
                 "bitwise_equal_to_chosen": r[shape].get(
                     "bitwise_equal_to_saved", True)})
    result = {"designs": {n: DESIGNS[n][0] for n in names},
              "summary": summary, "runs": runs,
              "sass_of_backward": sass_of_backward()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    for label, shapes in summary.items():
        print(label, json.dumps({s: [min(x["ms"]) for x in v]
                                 for s, v in shapes.items()}), flush=True)
    for kernel, counts in result["sass_of_backward"].items():
        print(kernel, counts["instructions"], counts["after_barrier"],
              flush=True)


if __name__ == "__main__":
    main()
