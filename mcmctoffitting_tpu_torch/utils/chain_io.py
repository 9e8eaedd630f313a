"""Chain persistence: the emcee text format and ``.npz`` checkpoints.

Port of ``mcmctoffitting_tpu/utils/chain_io.py``.  The text format is the
reference's, one row per walker per step, ``"{walkerIdx} {np.array-repr
of theta} {lnprob}"``, written and read as the JAX package does: through
the native codec (``utils/native``) when it builds, else by the same
Python writer and bracket-aware reader.  Either package reads the other's
files.

A checkpoint keeps the JAX package's ``.npz`` layout (``positions``,
``log_probs``, ``step``, ``extra_*``) and, in place of its threefry
``key``, the states of the sampler's two generators: ``generator_state``
(the moves' generator, with its device type in ``generator_device``) and
``eval_generator_state`` (the host generator that seeds the log-prob's
draws).  Restoring both continues the chain exactly.  A checkpoint written
by the JAX package has a ``key`` and no generator states: it loads with
``generator_state`` None, and the caller seeds both generators itself (a
threefry stream cannot be continued in torch).
"""
from __future__ import annotations

import io
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..sampler.stretch import EnsembleState


def append_chain_text(path: str, positions: np.ndarray,
                      log_probs: np.ndarray, *, mode: str = "a") -> None:
    """Append one or more steps in the reference's text format.

    positions: (W, D) or (S, W, D); log_probs: (W,) or (S, W).
    Row format matches ``fout.write("{0} {1} {2}\\n".format(k, pos[k],
    prob[k]))`` — numpy array repr with brackets, possibly line-wrapped by
    numpy for wide theta (the native codec writes each value as %.8e).
    """
    pos = np.asarray(positions)
    lp = np.asarray(log_probs)
    if pos.ndim == 2:
        pos, lp = pos[None], lp[None]
    text = None
    try:
        from .native import format_chain_text_native
        text = format_chain_text_native(pos, lp)
    except Exception:
        pass
    if text is None:
        buf = io.StringIO()
        for s in range(pos.shape[0]):
            for k in range(pos.shape[1]):
                buf.write("{0} {1} {2}\n".format(k, pos[s, k], lp[s, k]))
        text = buf.getvalue()
    with open(path, mode) as f:
        f.write(text)


def _parse_chain_text_py(text: str):
    """Pure-Python parser for the emcee text chain format, with numpy's
    line-wrapping of wide parameter vectors."""
    rows = []
    probs = []
    walker_ids = []
    lines = iter(text.splitlines())
    for line in lines:
        if not line.strip():
            continue
        lb = line.find("[")
        walker_ids.append(int(float(line[:lb])))
        vals = []
        while True:
            rb = line.find("]")
            seg = line[lb + 1: rb if rb != -1 else len(line)]
            vals.extend(float(v) for v in seg.split())
            if rb != -1:
                probs.append(float(line[rb + 1:]))
                break
            line = next(lines)
            lb = -1
        rows.append(vals)
    return np.asarray(rows), np.asarray(probs), np.asarray(walker_ids)


def read_chain_text(path: str):
    """Read a text chain file.

    Returns (chain (S, W, D), probs (S, W), n_params, n_walkers, n_steps),
    the reference's ``readChainFromFile`` 5-tuple.  Uses the native codec
    when it builds, else the Python parser.
    """
    with open(path) as f:
        text = f.read()
    parsed = None
    try:
        from .native import parse_chain_text_native
        parsed = parse_chain_text_native(text)
    except Exception:
        pass
    if parsed is None:
        parsed = _parse_chain_text_py(text)
    rows, probs, walker_ids = parsed
    if walker_ids.size == 0:
        raise ValueError(f"empty or unparseable chain file: {path}")
    n_walkers = int(walker_ids.max()) + 1
    n_steps = len(walker_ids) // n_walkers
    n_params = rows.shape[1]
    chain = rows[: n_steps * n_walkers].reshape(n_steps, n_walkers, n_params)
    prob = probs[: n_steps * n_walkers].reshape(n_steps, n_walkers)
    return chain, prob, n_params, n_walkers, n_steps


def save_checkpoint(path: str, state: EnsembleState, *,
                    extra: Optional[dict] = None) -> None:
    """Save an EnsembleState (+ optional metadata) for exact resume."""
    payload = {
        "positions": state.positions.detach().cpu().numpy(),
        "log_probs": state.log_probs.detach().cpu().numpy(),
        "generator_state": state.generator.get_state().numpy(),
        "generator_device": np.asarray(state.generator.device.type),
        "eval_generator_state": state.eval_generator.get_state().numpy(),
        "step": np.asarray(state.step, np.int64),
    }
    if extra:
        for k, v in extra.items():
            payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


class Checkpoint(NamedTuple):
    """A checkpoint's contents: numpy arrays, an int, and the generator
    states as uint8 tensors (None for a checkpoint of the JAX package)."""

    positions: np.ndarray               # (W, D) float32
    log_probs: np.ndarray               # (W,) float32
    step: int
    generator_state: Optional[torch.Tensor]
    generator_device: Optional[str]     # 'cuda' or 'cpu'
    eval_generator_state: Optional[torch.Tensor]
    extra: dict


def load_checkpoint(path: str) -> Checkpoint:
    """Read a checkpoint of either package (a checkpoint of the JAX
    package stores a threefry ``key`` in place of the generator states)."""
    with np.load(path) as z:
        gen_state = eval_state = gen_device = None
        if "generator_state" in z.files:
            gen_state = torch.from_numpy(np.array(z["generator_state"]))
            gen_device = str(z["generator_device"])
            eval_state = torch.from_numpy(
                np.array(z["eval_generator_state"]))
        return Checkpoint(
            np.asarray(z["positions"], np.float32),
            np.asarray(z["log_probs"], np.float32), int(z["step"]),
            gen_state, gen_device, eval_state,
            {k[6:]: z[k] for k in z.files if k.startswith("extra_")})
