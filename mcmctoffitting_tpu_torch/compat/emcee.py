"""emcee 2.x API shim over the port's ensemble sampler.

Port of ``mcmctoffitting_tpu/compat/emcee.py``.  The reference's drivers
are written against emcee 2's classes: ``emcee.EnsembleSampler(nWalkers,
nDim, lnprob, kwargs={...}, threads=N)`` with the ``for pos, prob, rstate
in sampler.sample(...)`` segment loop (``tests/simultFit.py:701-790``,
``tests/csi_oneBD.py:863-947``).  This module reproduces that class's
construction, generator, attribute and layout conventions, so that such
scripts run unmodified while the moves execute on the port's samplers.

Two execution backends, chosen at the first ``sample()``:

* ``torch`` -- the function takes a batch of walkers, a (W, D) float32
  tensor, and returns their (W,) log-probs as a tensor: one batched call
  evaluates a half-ensemble, and the red-black stretch move is
  ``sampler/stretch.py``'s, on ``device`` (the GPU unless the caller asks
  for the CPU);
* ``host`` -- arbitrary Python/numpy functions of one walker (the literal
  reference use case): a plain numpy red-black stretch move evaluates the
  walkers in a host loop, exactly like emcee's ``threads=1`` path.

``backend='auto'`` calls the function once on the initial walkers as a
(W, D) tensor on ``device`` and chooses by what it returns: a (W,) tensor
selects the torch backend, anything else (a float of one walker) the host
backend, with a warning.  An exception of that call is the caller's: it
propagates, with a note that a function of one numpy walker which cannot
take a tensor needs ``backend='host'``.  ``threads=`` / ``pool=`` are
accepted and ignored: the walker axis is the parallel axis here.

Deliberate deviations from emcee 2 (documented, all small):

* randomness comes from an explicit ``seed=`` (default 0) instead of the
  global numpy state; ``rstate`` yielded/accepted is this shim's opaque
  random state (the torch backend's generator state, the host backend's
  numpy ``Generator``);
* the ensemble is split red-black (even/odd index) rather than
  first-half/second-half -- same detailed-balance argument, same
  stationary distribution;
* ``nwalkers`` must be even (emcee asserts the same).

Differences from the JAX package's shim, by design: its ``jax`` backend
(a per-walker JAX-traceable function, vmapped) is the ``torch`` backend
here, and ``backend='jax'`` raises a ``ValueError`` that says so; 'auto'
reads the probe's result instead of catching its failure (the JAX shim
catches a tracing failure, before anything ran on the device; here the
probe is a real call on the device, whose failure is not a choice of
backend); ``PTSampler`` waits for the port's parallel tempering
(``sampler/pt.py``) and raises ``NotImplementedError``.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.forward import not_ported, resolve_device
from ..sampler import stretch as _stretch
from ..utils.diagnostics import integrated_autocorr_time

__all__ = ["EnsembleSampler", "PTSampler"]


def _wrap(fn: Callable, args, kwargs) -> Callable:
    args = tuple(args or ())
    kwargs = dict(kwargs or {})
    if not args and not kwargs:
        return fn
    return lambda theta: fn(theta, *args, **kwargs)


def _host_stretch_halves(pos, lp, call, rng, a):
    """One numpy red-black stretch step in place; returns accept mask (W,)."""
    n_walkers, n_dim = pos.shape
    n_half = n_walkers // 2
    acc = np.zeros(n_walkers, bool)
    for parity in (0, 1):
        active = np.arange(parity, n_walkers, 2)
        passive = np.arange(1 - parity, n_walkers, 2)
        z = ((a - 1.0) * rng.random(n_half) + 1.0) ** 2 / a
        j = rng.integers(0, n_half, n_half)
        partners = pos[passive[j]]
        prop = partners + z[:, None] * (pos[active] - partners)
        lp_prop = np.array([float(call(p)) for p in prop])
        log_ratio = (n_dim - 1.0) * np.log(z) + lp_prop - lp[active]
        ok = np.log(rng.random(n_half)) < log_ratio
        pos[active[ok]] = prop[ok]
        lp[active[ok]] = lp_prop[ok]
        acc[active] = ok
    return acc


def _stack_cached(obj, name, steps, axis):
    """Stack a step list once per length: reference drivers read .chain
    inside their per-iteration progress loops, and emcee 2 hands back a
    preallocated ndarray there -- an uncached np.stack would make those
    loops O(S^2) in chain length."""
    cache = getattr(obj, "_stack_cache", None)
    if cache is None:
        cache = {}
        obj._stack_cache = cache
    hit = cache.get(name)
    if hit is not None and hit[0] == len(steps):
        return hit[1]
    arr = np.stack(steps, axis=axis)
    cache[name] = (len(steps), arr)
    return arr


class EnsembleSampler:
    """emcee-2-compatible affine-invariant ensemble sampler.

    Matches the surface the reference drives: ``.sample()`` generator
    yielding ``(pos, lnprob, rstate)``, ``.run_mcmc()``, ``.chain``
    (nwalkers, nsteps, ndim), ``.flatchain``, ``.lnprobability``,
    ``.acceptance_fraction``, ``.acor`` / ``.get_autocorr_time()``,
    ``.reset()``, and ``thin`` in ``sample``.  ``device`` is where the
    torch backend runs (the GPU unless the caller asks for the CPU; the
    host backend needs none).
    """

    def __init__(self, nwalkers: int, dim: int, lnpostfn: Callable, *,
                 a: float = 2.0, args=None, kwargs=None,
                 threads: int = 1, pool: Any = None,
                 live_dangerously: bool = False,
                 runtime_sortingfn: Any = None,
                 seed: int = 0, backend: str = "auto", device="cuda"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        if nwalkers < 2 * dim and not live_dangerously:
            warnings.warn("nwalkers < 2*dim degrades the stretch move "
                          "(emcee raises here)")
        del threads, pool, runtime_sortingfn  # walker axis is the pool
        if backend == "jax":
            raise ValueError(
                "backend='jax' is the JAX package's; this port's batched "
                "backend is 'torch' (a (W, D) tensor -> (W,) log-prob "
                "function), or 'host' for any Python function")
        if backend not in ("auto", "torch", "host"):
            raise ValueError(
                f"backend must be auto|torch|host, got {backend}")
        self.nwalkers, self.dim, self.a = nwalkers, dim, a
        self._call = _wrap(lnpostfn, args, kwargs)
        self._backend_req = backend
        self.backend: Optional[str] = None   # resolved at first sample()
        self.device = None if backend == "host" else resolve_device(device)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._state: Optional[_stretch.EnsembleState] = None
        self._step = None
        self.reset()

    # -- emcee surface -------------------------------------------------
    def reset(self):
        """Clear the stored chain and counters (keeps the random state)."""
        self._stack_cache = {}   # same-length reuse after reset = stale
        self._pos_steps: list[np.ndarray] = []
        self._lp_steps: list[np.ndarray] = []
        self._naccepted = np.zeros(self.nwalkers)
        self.iterations = 0
        self._last = None

    @property
    def chain(self) -> np.ndarray:
        """(nwalkers, nsteps, ndim) -- emcee's walker-major layout."""
        if not self._pos_steps:
            return np.empty((self.nwalkers, 0, self.dim))
        return _stack_cached(self, "pos", self._pos_steps, 1)

    @property
    def flatchain(self) -> np.ndarray:
        return self.chain.reshape(-1, self.dim)

    @property
    def lnprobability(self) -> np.ndarray:
        """(nwalkers, nsteps)."""
        if not self._lp_steps:
            return np.empty((self.nwalkers, 0))
        return _stack_cached(self, "lp", self._lp_steps, 1)

    @property
    def flatlnprobability(self) -> np.ndarray:
        return self.lnprobability.reshape(-1)

    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self._naccepted / max(self.iterations, 1)

    def get_autocorr_time(self, **kwargs) -> np.ndarray:
        """Per-parameter integrated autocorrelation time (D,)."""
        chain_swd = self.chain.transpose(1, 0, 2)   # -> (S, W, D)
        return integrated_autocorr_time(chain_swd)

    @property
    def acor(self) -> np.ndarray:
        return self.get_autocorr_time()

    def get_lnprob(self, p) -> float:
        if self.backend == "torch":
            return float(self._call(self._tensor(p)[None])[0])
        return float(self._call(np.asarray(p)))

    # -- backends --------------------------------------------------------
    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.device)

    def _logp_batch(self, thetas, generator):
        return self._call(thetas)

    def _resolve_backend(self, p0):
        if self._backend_req == "host":
            self.backend = "host"
            return
        try:
            lp = self._call(self._tensor(p0))
        except Exception as exc:
            if self._backend_req == "auto":
                exc.add_note("backend='auto' calls the log-probability on "
                             "a (W, D) tensor first; a function of one "
                             "numpy walker takes backend='host'")
            raise
        if isinstance(lp, torch.Tensor) and tuple(lp.shape) == (
                self.nwalkers,):
            self._step = _stretch.make_step(self._logp_batch, self.a)
            self.backend = "torch"
            return
        why = f"it returned {type(lp).__name__}, not a (W,) tensor"
        if self._backend_req == "torch":
            raise TypeError("backend='torch' needs a log-probability of a "
                            "(W, D) tensor returning (W,); " + why)
        warnings.warn("log-probability does not take a batch of walkers "
                      f"as a tensor ({why}); using the host (numpy) "
                      "backend")
        self.backend = "host"

    def _set_state(self, p0, lnprob0, rstate0):
        p0 = np.asarray(p0, np.float64)
        if self.backend == "torch":
            if self._state is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(self._seed)
                eval_generator = torch.Generator().manual_seed(self._seed)
                step = 0
            else:
                generator, eval_generator = (self._state.generator,
                                             self._state.eval_generator)
                step = self._state.step
            if rstate0 is not None:
                generator.set_state(rstate0)
            pos = self._tensor(p0)
            lp = (self._call(pos) if lnprob0 is None
                  else self._tensor(lnprob0))
            self._state = _stretch.EnsembleState(
                pos, lp.to(torch.float32), generator, eval_generator, step)
        else:
            if rstate0 is not None:
                self._rng = rstate0
            self._host_pos = p0.copy()
            if lnprob0 is not None:
                self._host_lp = np.asarray(lnprob0, np.float64).copy()
            else:
                self._host_lp = np.array(
                    [float(self._call(p)) for p in self._host_pos])

    def sample(self, p0, lnprob0=None, rstate0=None, *, iterations: int = 1,
               thin: int = 1, storechain: bool = True):
        """Generator: advance the ensemble, yielding (pos, lnprob, rstate)
        after every iteration -- emcee 2's segment-loop contract."""
        if self.backend is None:
            self._resolve_backend(np.asarray(p0, np.float64))
        self._set_state(p0, lnprob0, rstate0)

        for i in range(int(iterations)):
            if self.backend == "torch":
                self._state, acc_t = self._step(self._state)
                pos = self._state.positions.double().cpu().numpy()
                lp = self._state.log_probs.double().cpu().numpy()
                acc = acc_t.cpu().numpy()
                rstate = self._state.generator.get_state()
            else:
                acc = _host_stretch_halves(self._host_pos, self._host_lp,
                                           self._call, self._rng, self.a)
                pos, lp = self._host_pos.copy(), self._host_lp.copy()
                rstate = self._rng
            self._naccepted += acc
            self.iterations += 1
            if storechain and i % thin == 0:
                # emcee 2 stores iterations 0, thin, 2*thin, ... --
                # ceil(iterations/thin) rows
                self._pos_steps.append(pos)
                self._lp_steps.append(lp)
            self._last = (pos, lp, rstate)
            yield pos, lp, rstate

    def run_mcmc(self, pos0, N, *, rstate0=None, lnprob0=None, **kwargs):
        """Run ``N`` steps, returning the final ``(pos, lnprob, rstate)``."""
        if pos0 is None:
            if self._last is None:
                raise ValueError("run_mcmc(None, ...) needs a previous run")
            pos0, lnprob0, rstate0 = self._last
        result = None
        for result in self.sample(pos0, lnprob0, rstate0,
                                  iterations=N, **kwargs):
            pass
        return result


class PTSampler:
    """emcee 2's parallel-tempering sampler: it waits for the port of
    ``sampler/pt.py`` and raises ``NotImplementedError``."""

    def __init__(self, *args, **kwargs):
        raise not_ported("compat/emcee.py::PTSampler (sampler/pt.py)",
                         "the parallel-tempering slice: sampler/pt.py and "
                         "shifting_gaussian")
