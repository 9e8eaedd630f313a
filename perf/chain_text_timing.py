"""Time the chain-text reader of mcmctoffitting_tpu_torch: the native
codec (utils/native, C++ through ctypes) against the Python parser, on a
chain of 256 walkers x 9 parameters x 2,000 steps written by the
package's own writer (the native formatter, the CLIs' format); and the
writers themselves on one segment of 50 steps.

    PYTHONPATH=. python perf/chain_text_timing.py [--steps 2000] [--reps 3]

Prints one JSON object: the file's size, the best of ``--reps`` wall-clock
seconds of each reader (and of the codec's one-time build), whether the
two readers agree, and the seconds per 50-step segment of each writer.
Host CPU work only; no GPU is used.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import tempfile
import time

import numpy as np

from mcmctoffitting_tpu_torch.utils import chain_io, native


def best_of(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walkers", type=int, default=256)
    ap.add_argument("--params", type=int, default=9)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    scale = np.geomspace(0.1, 5e4, args.params)
    pos = (rng.standard_normal((args.steps, args.walkers, args.params))
           * scale).astype(np.float32)
    lp = (-1e5 * rng.random((args.steps, args.walkers))).astype(np.float32)

    t0 = time.perf_counter()
    native._load()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mainchain.dat")
        chain_io.append_chain_text(path, pos, lp, mode="w")
        with open(path) as f:
            text = f.read()
        native_s, parsed_n = best_of(
            lambda: native.parse_chain_text_native(text), args.reps)
        python_s, parsed_p = best_of(
            lambda: chain_io._parse_chain_text_py(text), args.reps)
        seg = 50
        write_native_s, _ = best_of(
            lambda: native.format_chain_text_native(pos[:seg], lp[:seg]),
            args.reps)

        def python_writer():
            buf = []
            for s in range(seg):
                for k in range(args.walkers):
                    buf.append("{0} {1} {2}\n".format(k, pos[s, k], lp[s, k]))
            return "".join(buf)

        write_python_s, _ = best_of(python_writer, 1)
        size = os.path.getsize(path)
    agree = all(np.array_equal(a, b) for a, b in zip(parsed_n, parsed_p))
    print(json.dumps({
        "host": platform.processor() or platform.machine(),
        "cpus": os.cpu_count(),
        "chain": [args.steps, args.walkers, args.params],
        "file_mb": size / 1e6,
        "native_build_s": build_s,
        "read_native_s": native_s, "read_python_s": python_s,
        "saved_by_native_s": python_s - native_s,
        "readers_agree": agree,
        "write_segment_of": [seg, args.walkers, args.params],
        "write_native_s": write_native_s,
        "write_python_s": write_python_s,
    }))


if __name__ == "__main__":
    main()
