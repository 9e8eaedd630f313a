"""emcee 2.x API shim over the port's ensemble sampler.

Port of ``mcmctoffitting_tpu/compat/emcee.py``.  The reference's drivers
are written against emcee 2's classes: ``emcee.EnsembleSampler(nWalkers,
nDim, lnprob, kwargs={...}, threads=N)`` with the ``for pos, prob, rstate
in sampler.sample(...)`` segment loop (``tests/simultFit.py:701-790``,
``tests/csi_oneBD.py:863-947``).  This module reproduces that class's
construction, generator, attribute and layout conventions, so that such
scripts run unmodified while the moves execute on the port's samplers;
``PTSampler`` does the same for emcee 2's parallel-tempering sampler
(``tests/shiftingGaussian_brute.py:352-363``).

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
backend).  ``PTSampler`` follows the same rules: its torch backend runs
``sampler/pt.py`` with ``logl`` and ``logp`` as batched functions of (N, D)
tensors, its host backend the numpy loop over walkers, and 'auto' chooses
by what the two functions return on the initial walkers.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.forward import resolve_device
from ..sampler import pt as _pt
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
    """emcee-2-compatible parallel-tempering sampler.

    Construction and generator semantics match the reference's use
    (``tests/shiftingGaussian_brute.py:352-363``): ``PTSampler(ntemps,
    nwalkers, dim, logl, logp, loglkwargs=...)``, ``.sample(p0,
    lnprob0=, lnlike0=, iterations=, thin=)`` yielding ``(p, lnprob,
    lnlike)``, ``.reset()``, ``.chain`` (ntemps, nwalkers, steps, dim),
    plus ``thermodynamic_integration_log_evidence``.  Backends as the
    ensemble sampler's: ``torch`` runs ``sampler/pt.py``'s tempered stretch
    and exchange on ``device`` with ``logl`` and ``logp`` as batched
    functions of (N, D) tensors; ``host`` is a numpy loop over walkers of
    one-walker functions; ``'auto'`` calls both functions once on the
    initial walkers as an (N, D) tensor and chooses by what they return,
    letting their exceptions through.
    """

    def __init__(self, ntemps: int, nwalkers: int, dim: int,
                 logl: Callable, logp: Callable, *,
                 a: float = 2.0, betas=None,
                 threads: int = 1, pool: Any = None,
                 loglargs=None, logpargs=None,
                 loglkwargs=None, logpkwargs=None,
                 seed: int = 0, backend: str = "auto", device="cuda"):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        del threads, pool
        if backend not in ("auto", "torch", "host"):
            raise ValueError(
                f"backend must be auto|torch|host, got {backend}")
        self.ntemps, self.nwalkers, self.dim, self.a = (ntemps, nwalkers,
                                                        dim, a)
        self.betas = np.asarray(
            _pt.default_beta_ladder(ntemps) if betas is None else betas,
            np.float64)
        if self.betas.shape != (ntemps,):
            raise ValueError("betas must have shape (ntemps,)")
        self._logl = _wrap(logl, loglargs, loglkwargs)
        self._logp = _wrap(logp, logpargs, logpkwargs)
        self._backend_req = backend
        self.backend: Optional[str] = None
        self.device = None if backend == "host" else resolve_device(device)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._state: Optional[_pt.PTState] = None
        self.reset()

    def reset(self):
        self._stack_cache = {}   # same-length reuse after reset = stale
        self._pos_steps: list[np.ndarray] = []    # each (T, W, D)
        self._ll_steps: list[np.ndarray] = []     # each (T, W)
        self._lp_steps: list[np.ndarray] = []     # tempered lnprob (T, W)
        self._naccepted = np.zeros((self.ntemps, self.nwalkers))
        self._nswap = np.zeros(self.ntemps)
        self._nswap_accepted = np.zeros(self.ntemps)
        self.iterations = 0

    # -- emcee surface -------------------------------------------------
    @property
    def chain(self) -> np.ndarray:
        """(ntemps, nwalkers, nsteps, ndim)."""
        if not self._pos_steps:
            return np.empty((self.ntemps, self.nwalkers, 0, self.dim))
        return _stack_cached(self, "pos", self._pos_steps, 2)

    @property
    def lnlikelihood(self) -> np.ndarray:
        if not self._ll_steps:
            return np.empty((self.ntemps, self.nwalkers, 0))
        return _stack_cached(self, "ll", self._ll_steps, 2)

    @property
    def lnprobability(self) -> np.ndarray:
        if not self._lp_steps:
            return np.empty((self.ntemps, self.nwalkers, 0))
        return _stack_cached(self, "lp", self._lp_steps, 2)

    @property
    def flatchain(self) -> np.ndarray:
        return self.chain.reshape(self.ntemps, -1, self.dim)

    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self._naccepted / max(self.iterations, 1)

    @property
    def tswap_acceptance_fraction(self) -> np.ndarray:
        """(ntemps,) -- emcee's per-temperature attribution: each adjacent
        pair's attempts/accepts are credited to both participating rungs."""
        with np.errstate(invalid="ignore"):
            return np.where(self._nswap > 0,
                            self._nswap_accepted / self._nswap, np.nan)

    def thermodynamic_integration_log_evidence(self, fburnin: float = 0.1):
        """(ln Z, d ln Z) from the stored tempered log-likelihood chain."""
        ll_stw = self.lnlikelihood.transpose(2, 0, 1)   # -> (S, T, W)
        return _pt.thermodynamic_integration_log_evidence(
            ll_stw, self.betas, fburnin=fburnin)

    # -- backends --------------------------------------------------------
    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.device)

    def _logl_batch(self, thetas, generator):
        return self._logl(thetas)

    def _logp_batch(self, thetas, generator):
        return self._logp(thetas)

    def _resolve_backend(self, p0):
        if self._backend_req == "host":
            self.backend = "host"
            return
        flat = self._tensor(p0.reshape(-1, self.dim))
        try:
            out = (self._logl(flat), self._logp(flat))
        except Exception as exc:
            if self._backend_req == "auto":
                exc.add_note("backend='auto' calls logl and logp on an "
                             "(N, D) tensor first; functions of one numpy "
                             "walker take backend='host'")
            raise
        n = flat.shape[0]
        if all(isinstance(v, torch.Tensor) and tuple(v.shape) == (n,)
               for v in out):
            self._step = _pt.make_pt_step(self._logl_batch,
                                          self._logp_batch, self.betas,
                                          self.a)
            self.backend = "torch"
            return
        why = (f"they returned {type(out[0]).__name__} and "
               f"{type(out[1]).__name__}, not (N,) tensors")
        if self._backend_req == "torch":
            raise TypeError("backend='torch' needs logl and logp of an "
                            "(N, D) tensor returning (N,); " + why)
        warnings.warn("logl/logp do not take a batch of walkers as a "
                      f"tensor ({why}); using the host (numpy) backend")
        self.backend = "host"

    def _set_state(self, p0, lnprob0, lnlike0):
        p0 = np.asarray(p0, np.float64)
        if lnlike0 is not None:
            ll = np.asarray(lnlike0, np.float64)
            if lnprob0 is not None:
                lp = np.asarray(lnprob0, np.float64) \
                    - self.betas[:, None] * ll
            elif self.backend == "host":
                lp = np.array([[float(self._logp(w)) for w in rung]
                               for rung in p0])
            else:
                lp = self._logp(self._tensor(p0.reshape(-1, self.dim)))
                lp = lp.double().cpu().numpy().reshape(ll.shape)
        elif self.backend == "host":
            ll = np.array([[float(self._logl(w)) for w in rung]
                           for rung in p0])
            lp = np.array([[float(self._logp(w)) for w in rung]
                           for rung in p0])
        else:
            ll = lp = None
        if self.backend == "torch":
            if self._state is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(self._seed)
                eval_generator = torch.Generator().manual_seed(self._seed)
                step = 0
            else:
                generator, eval_generator, step = (
                    self._state.generator, self._state.eval_generator,
                    self._state.step)
            pos = self._tensor(p0)
            if ll is None:
                st = _pt.init_pt_state(pos, self._logl_batch,
                                       self._logp_batch,
                                       generator=generator,
                                       eval_generator=eval_generator)
                ll_t, lp_t = st.log_like, st.log_prior
            else:
                ll_t, lp_t = self._tensor(ll), self._tensor(lp)
            self._state = _pt.PTState(pos, ll_t, lp_t, generator,
                                      eval_generator, step)
        else:
            self._host_pos = p0.copy()
            self._host_ll, self._host_lp = ll.copy(), lp.copy()

    def _host_step(self):
        """Numpy tempered stretch + adjacent replica exchange."""
        pos, ll, lp = self._host_pos, self._host_ll, self._host_lp
        n_dim = self.dim
        acc_all = np.zeros((self.ntemps, self.nwalkers), bool)
        for t in range(self.ntemps):
            beta = self.betas[t]
            # tempered target: logp + beta * logl; track both components
            n_half = self.nwalkers // 2
            for parity in (0, 1):
                active = np.arange(parity, self.nwalkers, 2)
                passive = np.arange(1 - parity, self.nwalkers, 2)
                z = ((self.a - 1.0) * self._rng.random(n_half) + 1.0) ** 2 \
                    / self.a
                j = self._rng.integers(0, n_half, n_half)
                partners = pos[t][passive[j]]
                prop = partners + z[:, None] * (pos[t][active] - partners)
                ll_prop = np.array([float(self._logl(p)) for p in prop])
                lp_prop = np.array([float(self._logp(p)) for p in prop])
                new = lp_prop + beta * ll_prop
                old = lp[t][active] + beta * ll[t][active]
                ok = np.log(self._rng.random(n_half)) \
                    < (n_dim - 1.0) * np.log(z) + new - old
                idx = active[ok]
                pos[t][idx] = prop[ok]
                ll[t][idx] = ll_prop[ok]
                lp[t][idx] = lp_prop[ok]
                acc_all[t][active] = ok
        # replica exchange, coldest pair last (as sampler/pt.py)
        for i in range(self.ntemps - 2, -1, -1):
            perm = self._rng.permutation(self.nwalkers)
            ll_hot = ll[i + 1][perm]
            log_ratio = (self.betas[i] - self.betas[i + 1]) \
                * (ll_hot - ll[i])
            ok = np.log(self._rng.random(self.nwalkers)) < log_ratio
            sw = perm[ok]
            (pos[i][ok], pos[i + 1][sw]) = (pos[i + 1][sw].copy(),
                                            pos[i][ok].copy())
            (ll[i][ok], ll[i + 1][sw]) = (ll[i + 1][sw].copy(),
                                          ll[i][ok].copy())
            (lp[i][ok], lp[i + 1][sw]) = (lp[i + 1][sw].copy(),
                                          lp[i][ok].copy())
            self._credit_swaps(i, int(ok.sum()))
        return acc_all

    def _credit_swaps(self, pair: int, n_accepted) -> None:
        for rung in (pair, pair + 1):
            self._nswap[rung] += self.nwalkers
            self._nswap_accepted[rung] += n_accepted

    def sample(self, p0, lnprob0=None, lnlike0=None, *, iterations: int = 1,
               thin: int = 1, storechain: bool = True):
        """Generator yielding (p, lnprob, lnlike) each iteration."""
        if self.backend is None:
            self._resolve_backend(np.asarray(p0, np.float64))
        self._set_state(p0, lnprob0, lnlike0)

        for i in range(int(iterations)):
            if self.backend == "torch":
                self._state, acc_t, swaps_t = self._step(self._state)
                pos = self._state.positions.double().cpu().numpy()
                ll = self._state.log_like.double().cpu().numpy()
                lp = self._state.log_prior.double().cpu().numpy()
                acc = acc_t.cpu().numpy()
                for r, n_ok in enumerate(swaps_t.cpu().numpy()):
                    self._credit_swaps(r, float(n_ok))
            else:
                acc = self._host_step()
                pos = self._host_pos.copy()
                ll = self._host_ll.copy()
                lp = self._host_lp.copy()
            self._naccepted += acc
            self.iterations += 1
            lnprob = lp + self.betas[:, None] * ll
            if storechain and i % thin == 0:
                # emcee 2 stores iterations 0, thin, 2*thin, ... --
                # ceil(iterations/thin) rows
                self._pos_steps.append(pos)
                self._ll_steps.append(ll)
                self._lp_steps.append(lnprob)
            yield pos, lnprob, ll
