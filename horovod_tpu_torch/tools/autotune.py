"""Online Bayesian-optimization autotuner.

The port's own copy of ``horovod_tpu/tools/autotune.py``, whose parity is
``horovod/common/parameter_manager.cc`` + ``optim/bayesian_optimization.cc``
+ ``optim/gaussian_process.cc``: tune knobs against observed throughput
with a GP + expected-improvement loop, warm-started by a few random
samples, logging trials to ``HOROVOD_AUTOTUNE_LOG``. The search
(:class:`Autotuner`, :class:`GaussianProcess`, :func:`expected_improvement`)
is the reference's line for line, so the same seed and scores give the
same proposals.

The knob the port's train step tunes is the fusion threshold of
``DistributedOptimizer``'s buckets (``train.dp._autotuned_train_step``):
each knob set re-plans the buckets and rebuilds the step; nothing is
compiled again.

:class:`StepAutotuner` differs from the reference in two places: it waits
for the card (``torch.cuda.synchronize``) where JAX blocks on the result,
and in a world of more than one rank the trial's time is the largest over
the ranks (one scalar all-reduce on the CPU group), so every rank reports
the same score, proposes the same knobs and plans the same buckets — the
ranks' collectives must match.

Usage (the reference's propose→measure→report cycle)::

    tuner = Autotuner({"fusion_threshold_bytes": LogIntDim(1<<20, 1<<28)})
    while not tuner.converged():
        params = tuner.propose()
        score = measure_throughput(**params)    # higher is better
        tuner.report(params, score)
    best = tuner.best_params()
"""

from __future__ import annotations

import csv
import math
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.logging import get_logger


# --- search space ------------------------------------------------------------

@dataclass(frozen=True)
class Dim:
    """Continuous dimension in [lo, hi]."""
    lo: float
    hi: float

    def to_unit(self, v: float) -> float:
        return (float(v) - self.lo) / (self.hi - self.lo + 1e-12)

    def from_unit(self, u: float) -> float:
        return self.lo + u * (self.hi - self.lo)


@dataclass(frozen=True)
class IntDim(Dim):
    def from_unit(self, u: float) -> int:
        return int(round(super().from_unit(u)))


@dataclass(frozen=True)
class LogIntDim(Dim):
    """Integer dimension searched in log2 space (thresholds, sizes)."""

    def to_unit(self, v: float) -> float:
        return ((math.log2(float(v)) - math.log2(self.lo))
                / (math.log2(self.hi) - math.log2(self.lo) + 1e-12))

    def from_unit(self, u: float) -> int:
        lg = math.log2(self.lo) + u * (math.log2(self.hi)
                                       - math.log2(self.lo))
        return int(round(2 ** lg))


@dataclass(frozen=True)
class CatDim:
    """Categorical dimension (one-unit-interval binning)."""
    choices: Tuple[Any, ...]

    def to_unit(self, v: Any) -> float:
        return (self.choices.index(v) + 0.5) / len(self.choices)

    def from_unit(self, u: float) -> Any:
        i = min(int(u * len(self.choices)), len(self.choices) - 1)
        return self.choices[i]


# --- gaussian process (reference: gaussian_process.cc) -----------------------

class GaussianProcess:
    """RBF-kernel GP regression with observation noise; exact inference via
    Cholesky (the reference's gaussian_process.cc does the same with
    Eigen)."""

    def __init__(self, length_scale: float = 0.2, signal_var: float = 1.0,
                 noise_var: float = 1e-4):
        self.ls = length_scale
        self.sv = signal_var
        self.nv = noise_var
        self._X: Optional[np.ndarray] = None
        self._alpha = None
        self._L = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.sv * np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        X = np.atleast_2d(np.asarray(X, np.float64))
        y = np.asarray(y, np.float64).reshape(-1)
        self._ymean = y.mean() if y.size else 0.0
        self._ystd = y.std() + 1e-9
        yc = (y - self._ymean) / self._ystd
        K = self._k(X, X) + self.nv * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yc))
        self._X = X

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Mean and std at query points (denormalised)."""
        Xs = np.atleast_2d(np.asarray(Xs, np.float64))
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(self.sv - (v ** 2).sum(0), 1e-12, None)
        return (mu * self._ystd + self._ymean,
                np.sqrt(var) * self._ystd)


def expected_improvement(mu: np.ndarray, sigma: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (maximisation form; reference:
    bayesian_optimization.cc)."""
    from math import erf, sqrt
    z = (mu - best - xi) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return (mu - best - xi) * cdf + sigma * pdf


# --- the tuner ---------------------------------------------------------------

class Autotuner:
    def __init__(self, space: Dict[str, "Dim | CatDim"],
                 warmup_trials: int = 5, max_trials: int = 30,
                 candidates_per_step: int = 256,
                 log_path: Optional[str] = None, seed: int = 0,
                 patience: int = 10):
        if not space:
            raise ValueError("empty search space")
        self.space = dict(space)
        self.names = sorted(space)
        self.warmup_trials = warmup_trials
        self.max_trials = max_trials
        self.candidates = candidates_per_step
        self.patience = patience
        self._rng = random.Random(seed)
        self._nprng = np.random.RandomState(seed)
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._params: List[Dict[str, Any]] = []
        self._log_path = log_path or os.environ.get("HOROVOD_AUTOTUNE_LOG")
        self._log_writer = None
        if self._log_path:
            f = open(self._log_path, "a", newline="")
            self._log_writer = (f, csv.writer(f))
            if f.tell() == 0:
                self._log_writer[1].writerow(
                    ["trial", *self.names, "score"])

    # -- propose / report (the reference's parameter_manager cycle) ----------

    def _to_unit(self, params: Dict[str, Any]) -> List[float]:
        return [self.space[n].to_unit(params[n]) for n in self.names]

    def _from_unit(self, u: Sequence[float]) -> Dict[str, Any]:
        return {n: self.space[n].from_unit(x)
                for n, x in zip(self.names, u)}

    def propose(self) -> Dict[str, Any]:
        if len(self._y) < self.warmup_trials:
            return self._from_unit([self._rng.random()
                                    for _ in self.names])
        gp = GaussianProcess()
        gp.fit(np.asarray(self._X), np.asarray(self._y))
        cand = self._nprng.rand(self.candidates, len(self.names))
        mu, sigma = gp.predict(cand)
        ei = expected_improvement(mu, sigma, max(self._y))
        return self._from_unit(cand[int(np.argmax(ei))])

    def report(self, params: Dict[str, Any], score: float) -> None:
        self._X.append(self._to_unit(params))
        self._y.append(float(score))
        self._params.append(dict(params))
        if self._log_writer:
            f, w = self._log_writer
            w.writerow([len(self._y), *[params[n] for n in self.names],
                        score])
            f.flush()
        get_logger().debug("autotune trial %d: %s -> %.4g", len(self._y),
                           params, score)

    # -- stopping / results ---------------------------------------------------

    def best_params(self) -> Dict[str, Any]:
        if not self._y:
            raise ValueError("no trials reported")
        return self._params[int(np.argmax(self._y))]

    def best_score(self) -> float:
        return max(self._y)

    def converged(self) -> bool:
        """Stop at max_trials, or when `patience` trials passed with no
        improvement (the reference stops when BO's suggestions stop
        moving)."""
        n = len(self._y)
        if n >= self.max_trials:
            return True
        if n < max(self.warmup_trials, self.patience):
            return False
        best_at = int(np.argmax(self._y))
        return (n - 1 - best_at) >= self.patience

    def close(self) -> None:
        if getattr(self, "_log_writer", None):
            self._log_writer[0].close()
            self._log_writer = None

    def __enter__(self) -> "Autotuner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


# --- transparent in-training autotuning --------------------------------------

class StepAutotuner:
    """Tune a train step WHILE training, the way the reference's
    ``parameter_manager`` does: every ``steps_per_trial`` steps the observed
    step rate is reported as the trial's score and the next proposal's
    step is built; after convergence the best knobs are locked in.
    Training progress is real throughout — trial steps update real state.

    ``build_step(**knobs) -> step_fn`` is the factory.

    Usage::

        tuner = StepAutotuner(
            lambda **kn: make_train_step(model, opt, loss_fn, **kn),
            {"scan_steps": IntDim(1, 8)})
        for batch, labels in data:
            state, loss = tuner.step(state, batch, labels)
        print(tuner.chosen)
    """

    def __init__(self, build_step, space: Dict[str, Any], *,
                 steps_per_trial: int = 10, skip_first: int = 1,
                 tuner: Optional[Autotuner] = None):
        import time as _time
        self._time = _time
        self.build_step = build_step
        self.tuner = tuner or Autotuner(space)
        self.steps_per_trial = steps_per_trial
        self.skip_first = skip_first  # per-trial warm-up steps to discount
        self.chosen: Optional[Dict[str, Any]] = None
        self._current: Optional[Dict[str, Any]] = None
        self._fn = None
        self._count = 0
        self._t0 = 0.0

    def _begin_trial(self) -> None:
        self._current = self.tuner.propose()
        self._fn = self.build_step(**self._current)
        self._count = 0
        if self.skip_first == 0:
            self._t0 = self._time.perf_counter()

    def step(self, *args, **kwargs):
        """Run one training step under the current knobs (tuning while not
        converged, best knobs afterwards)."""
        if self.chosen is None and self.tuner.converged():
            self.chosen = self.tuner.best_params()
            self._fn = self.build_step(**self.chosen)
            get_logger().info("autotune converged: %s (score %.4g)",
                              self.chosen, self.tuner.best_score())
        if self._fn is None:
            if self.chosen is None:
                self._begin_trial()
            else:
                self._fn = self.build_step(**self.chosen)
        out = self._fn(*args, **kwargs)
        if self.chosen is not None:
            return out
        return self._after_trial_step(out)

    @staticmethod
    def _wait() -> None:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @staticmethod
    def _agreed(dt: float) -> float:
        """The largest of the ranks' trial times (module doc)."""
        from ..core import context_api as _ctx
        if not _ctx.is_initialized() or _ctx.size() == 1:
            return dt
        import torch
        import torch.distributed as dist
        from ..collectives.ops import _cpu_group
        t = torch.tensor([dt], dtype=torch.float64)
        dist.all_reduce(t, dist.ReduceOp.MAX, group=_cpu_group(None))
        return float(t[0])

    def _after_trial_step(self, out):
        self._count += 1
        if self._count == self.skip_first and self.skip_first > 0:
            # Timing starts after the warm-up step(s).
            self._wait()
            self._t0 = self._time.perf_counter()
        elif self._count >= self.steps_per_trial + self.skip_first:
            self._wait()
            dt = self._agreed(self._time.perf_counter() - self._t0)
            self.tuner.report(self._current,
                              self.steps_per_trial / max(dt, 1e-9))
            if self.tuner.converged():
                self._fn = None  # next step() locks in the best knobs
            else:
                self._begin_trial()
        return out

    # Drop-in for the plain step: make_train_step returns a StepAutotuner
    # under HOROVOD_AUTOTUNE=1, and user loops call it like any step.
    def __call__(self, *args, **kwargs):
        return self.step(*args, **kwargs)
