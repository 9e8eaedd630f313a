"""ctypes bindings for the native chain codec (built on first use).

The port's copy of ``mcmctoffitting_tpu/utils/native``: the same C++
source (``chaincodec.cpp``) and the same C interface.  g++ compiles it on
first use into ``build/native/<hash>/_chaincodec.so`` at the root of the
checkout (listed in ``.gitignore``), keyed on a hash of the source and
flags, never next to the source.  Nothing is built at import time; a
missing toolchain raises only when the codec is called, and
``utils/chain_io`` then uses its Python reader and writer.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "chaincodec.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "native"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.POINTER(ctypes.c_double)),
        ("probs", ctypes.POINTER(ctypes.c_double)),
        ("walkers", ctypes.POINTER(ctypes.c_int64)),
        ("n_rows", ctypes.c_int64),
        ("n_params", ctypes.c_int64),
    ]


def _build() -> Path:
    """Compile the codec (once per source hash) and return the library."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    out_dir = _BUILD_ROOT / key.hexdigest()[:16]
    lib = out_dir / "_chaincodec.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: a concurrent reader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=1)
def _load():
    lib = ctypes.CDLL(str(_build()))
    lib.parse_chain_text.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(_ParseResult)]
    lib.parse_chain_text.restype = ctypes.c_int
    lib.free_parse_result.argtypes = [ctypes.POINTER(_ParseResult)]
    lib.format_chain_text.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.format_chain_text.restype = ctypes.POINTER(ctypes.c_char)
    lib.free_text.argtypes = [ctypes.POINTER(ctypes.c_char)]
    return lib


def parse_chain_text_native(text: str):
    """Parse the emcee text chain format. Returns (rows, probs, walker_ids)."""
    lib = _load()
    raw = text.encode()
    res = _ParseResult()
    rc = lib.parse_chain_text(raw, len(raw), ctypes.byref(res))
    if rc != 0:
        raise ValueError(f"native chain parse failed with code {rc}")
    try:
        n, d = res.n_rows, res.n_params
        rows = np.ctypeslib.as_array(res.rows, shape=(n, d)).copy() \
            if n else np.zeros((0, 0))
        probs = np.ctypeslib.as_array(res.probs, shape=(n,)).copy() \
            if n else np.zeros(0)
        walkers = np.ctypeslib.as_array(res.walkers, shape=(n,)).copy() \
            if n else np.zeros(0, np.int64)
    finally:
        lib.free_parse_result(ctypes.byref(res))
    return rows, probs, walkers


def format_chain_text_native(positions: np.ndarray,
                             probs: np.ndarray) -> str:
    """Format (S, W, D) positions + (S, W) probs as chain text."""
    lib = _load()
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    lp = np.ascontiguousarray(probs, dtype=np.float64)
    s, w, d = pos.shape
    out_len = ctypes.c_int64()
    ptr = lib.format_chain_text(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        s, w, d, ctypes.byref(out_len))
    if not ptr:
        raise MemoryError("native chain format failed")
    try:
        return ctypes.string_at(ptr, out_len.value).decode()
    finally:
        lib.free_text(ptr)
