"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all
started together) and links them into one shared library with a plain C
interface, for Hopper (``sm_90a``), on first use; ``ctypes`` loads it.
The build is keyed on a hash of the sources and flags and goes to
``build/kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), so a fresh checkout builds everything from its own
sources and later processes reuse the library.  Nothing here runs at
import time, so the module imports on a machine without ``nvcc``.

Flags: no ``--use_fast_math`` (approximate transcendentals bias the
Poisson sampler's acceptance test), and ``-fmad=false`` so that no
multiply-add is contracted: the kernels then round like their plain
PyTorch versions, op by op.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_NAME = "libmcmctof_kernels.so"
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (each returns an int: a cudaError_t,
# the bin cap of mcmctof_weighted_hist_max_bins, the byte count of
# mcmctof_tof_hist_plan, the K of mcmctof_tof_hist_bwd_plan, or the spans
# of mcmctof_transport_moments_tile)
_SIGNATURES = {
    # lam, out, n, row_len, n_rep, seed words (device, or null), seed0,
    # seed1, counter offset, block, stride, device, stream
    "mcmctof_poisson": [_P, _P, _L, _L, _L, _P, ctypes.c_uint32,
                        ctypes.c_uint32, ctypes.c_uint64, _L,
                        ctypes.c_uint64, _I, _P],
    # counter/key words (n, 6), out words (n, 4), n, device, stream
    "mcmctof_philox": [_P, _P, _L, _I, _P],
    # base, draws, zt (K, Be), zw (K, Be), max_b sum_k |zw| (1,), lo, hi,
    # scale, nb1, out, n_rows, n_runs, n_cells, n_ed, n_seg, n_pad, device,
    # stream
    "mcmctof_tof_hist": [_P] * 10 + [_I] * 7 + [_P],
    # gbar, base, zt (K, Be), zw (K, Be), lo, hi, scale, nb1, grad, n_rows,
    # n_runs, n_cells, n_ed, n_seg, n_pad, device, stream
    "mcmctof_tof_hist_bwd": [_P] * 9 + [_I] * 7 + [_P],
    # n_cells, n_seg, n_pad -> shared memory (bytes) of the fast kernel, or
    # 0 where the general kernel serves
    "mcmctof_tof_hist_plan": [_I] * 3,
    # n_seg -> the K the backward kernel is compiled for (10, 1), or 0 for
    # its general kernel
    "mcmctof_tof_hist_bwd_plan": [_I],
    # values, weights, out, parts, blocks, n_rows, row_len, n_valid, lo,
    # hi, scale, n_bins, device, stream
    "mcmctof_weighted_hist": [_P, _P, _P, _P, _L, _I, _L, _L, _F, _F, _F,
                              _I, _I, _P],
    "mcmctof_weighted_hist_max_bins": [],
    # n_rows, n_valid, n_bins, device, blocks (out)
    "mcmctof_weighted_hist_blocks": [_I, _L, _I, _I,
                                     ctypes.POINTER(ctypes.c_longlong)],
    # e0, steps, acc (int64 workspace), out, e_out, carry, n_rows, n, n_x,
    # n_sub, n_bins, a, p, q, floor, lo, hi, inv_width, device, stream
    "mcmctof_transport_moments": [_P] * 6 + [_I, _L, _I, _I, _I]
    + [_F] * 7 + [_I, _P],
    # n_x, n_bins -> spans per tile (n_x: one tile; 0: refused)
    "mcmctof_transport_moments_tile": [_I, _I],
    # params, row stride, column stride, edges, t_edges, out, n_walkers,
    # n_fine, truncated, exact, t_ref, 1 / t_scale, e0_lo, e0_hi, n_samples,
    # h * h / 12, 0.1 * h * h, device, stream
    "mcmctof_counts_rates": [_P, _L, _L, _P, _P, _P] + [_I] * 4 + [_F] * 7
    + [_I, _P],
    # device, stream: an empty kernel (the launch floor of utils/devtime.py)
    "mcmctof_empty_kernel": [_I, _P],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was reused
    ptxas_log: str         # the compiler's resource report ('' if reused)


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "mcmctoffitting_tpu_torch are built with the CUDA "
                       "toolkit on the machine with the GPU")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def current_stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (inside a CUDA graph capture: the capturing stream)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:            # no Stream object built per call
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        lib = load_library().lib
        msg = lib.mcmctof_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _compile_and_link(tmp_dir: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link;
    returns the compilers' output (the ptxas resource report)."""
    nvcc = _nvcc()
    procs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp_dir / (src.stem + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], False
    for _, proc in procs:
        logs.append(proc.communicate()[0])
        failed |= proc.returncode != 0
    log = "".join(logs)
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run(
        [nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp_dir / _LIB_NAME),
         *(str(obj) for obj, _ in procs)], capture_output=True, text=True)
    if link.returncode:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    return log


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    out_dir = _BUILD_ROOT / source_hash()
    path = out_dir / _LIB_NAME
    seconds, log = 0.0, ""
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
        t0 = time.perf_counter()
        log = _compile_and_link(tmp_dir)
        seconds = time.perf_counter() - t0
        os.replace(tmp_dir / _LIB_NAME, path)   # atomic: builds race safely
        shutil.rmtree(tmp_dir, ignore_errors=True)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mcmctof_error_string.argtypes = [ctypes.c_int]
    lib.mcmctof_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, seconds, log)
