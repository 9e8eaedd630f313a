"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, for Hopper (``sm_90a``), on first use; ``ctypes`` loads it.
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_NAME = "libmcmctof_kernels.so"
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    # lam, out, n, seed0, seed1, device, stream
    "mcmctof_poisson": [_P, _P, ctypes.c_longlong, ctypes.c_uint32,
                        ctypes.c_uint32, _I, _P],
    # counter/key words (n, 6), out words (n, 4), n, device, stream
    "mcmctof_philox": [_P, _P, ctypes.c_longlong, _I, _P],
    # base, draws, zt, zw, lo, hi, scale, nb1, out,
    # n_rows, n_runs, n_cells, n_ed, n_seg, n_pad, device, stream
    "mcmctof_tof_hist": [_P] * 9 + [_I] * 7 + [_P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        lib = load_library().lib
        msg = lib.mcmctof_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    out_dir = _BUILD_ROOT / source_hash()
    path = out_dir / _LIB_NAME
    seconds, log = 0.0, ""
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp, *cu],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)   # atomic: concurrent builds race safely
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mcmctof_error_string.argtypes = [ctypes.c_int]
    lib.mcmctof_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, seconds, log)
