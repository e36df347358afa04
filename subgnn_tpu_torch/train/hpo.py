"""Hyperparameter search driver (optuna-compatible spec, no optuna needed).

Consumes the reference's run-config search spec
(reference: SubGNN/train_config.py:53-86 + config_files/README.md):
    "hyperparams_optuna": {"batch_size": {"type": "suggest_categorical",
                                          "args": [[64, 128]]}, ...}
A built-in random/grid/TPE sampler with a JSON study file replicates the
reference's optuna study (it resumes from disk like the reference's sqlite
study, train_config.py:266-271).

A copy of subgnn_tpu/train/hpo.py without its optional optuna import (the
JAX package never uses optuna either): the same draws, study files and best
trial for the same seed.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..parallel.mesh import is_lead


class TrialPruned(Exception):
    """Raised inside an objective to stop an unpromising trial early."""


class Trial:
    """Minimal optuna.Trial stand-in (suggest_* API subset used by the
    reference configs, plus report/should_prune for median pruning)."""

    def __init__(self, rng: np.random.Generator,
                 fixed: Optional[Dict[str, Any]] = None,
                 study: "Study | None" = None,
                 sampler_hook: Optional[Callable[..., Any]] = None):
        self.rng = rng
        self.params: Dict[str, Any] = {}
        self.fixed = fixed or {}
        self.study = study
        self.sampler_hook = sampler_hook
        self.intermediate: Dict[int, float] = {}
        # free-form annotations persisted with the trial record (optuna
        # user_attrs analog) — e.g. seed_avg_search records n_seeds_scored
        # so raced (1-seed) values stay distinguishable on resume
        self.attrs: Dict[str, Any] = {}

    def _hook(self, name: str, kind: str, **meta):
        """Ask the study's sampler (e.g. TPE) for a value; None -> the
        caller falls back to a random draw."""
        if self.sampler_hook is None:
            return None
        return self.sampler_hook(name, kind, meta, self.rng)

    # --- pruning (median pruner semantics like optuna.pruners.MedianPruner,
    # the reference's pruner at train_config.py:242-243) ---

    def report(self, value: float, step: int):
        self.intermediate[step] = float(value)

    def should_prune(self, n_warmup_steps: int = 5,
                     n_min_trials: int = 2) -> bool:
        if self.study is None or not self.intermediate:
            return False
        step = max(self.intermediate)
        if step < n_warmup_steps:
            return False
        peers = [t["intermediate"].get(str(step)) for t in self.study.trials
                 if t.get("intermediate")]
        peers = [p for p in peers if p is not None]
        if len(peers) < n_min_trials:
            return False
        median = float(np.median(peers))
        best_so_far = max(self.intermediate.values()) \
            if self.study.direction == "maximize" \
            else min(self.intermediate.values())
        if self.study.direction == "maximize":
            return best_so_far < median
        return best_so_far > median

    def _record(self, name, value):
        self.params[name] = value
        return value

    def suggest_categorical(self, name, choices):
        if name in self.params:
            # optuna semantics: a repeated suggest name within one trial
            # returns the already-drawn value. The reference's in-driver
            # ranges rely on this — linear_hidden_dim_1/2 share the name
            # 'linear_hidden_dim' (train.py:176-177), so they are equal.
            return self.params[name]
        if name in self.fixed:
            return self._record(name, self.fixed[name])
        v = self._hook(name, "categorical", choices=choices)
        if v is not None:
            return self._record(name, v)
        return self._record(name, choices[int(self.rng.integers(len(choices)))])

    def suggest_int(self, name, low, high, step=1, log=False):
        if name in self.params:
            return self.params[name]  # optuna repeated-name semantics
        if name in self.fixed:
            return self._record(name, self.fixed[name])
        v = self._hook(name, "int", low=low, high=high, log=log)
        if v is not None:
            return self._record(name, int(np.clip(int(round(v)), low, high)))
        if log:
            v = int(round(math.exp(self.rng.uniform(math.log(low),
                                                    math.log(high)))))
            return self._record(name, int(np.clip(v, low, high)))
        return self._record(name, int(self.rng.integers(low, high + 1)))

    def suggest_float(self, name, low, high, step=None, log=False):
        if name in self.params:
            return self.params[name]  # optuna repeated-name semantics
        if name in self.fixed:
            return self._record(name, self.fixed[name])
        v = self._hook(name, "float", low=low, high=high, log=log, step=step)
        if v is not None:
            if step:
                v = low + step * round((v - low) / step)
            return self._record(name, float(np.clip(v, low, high)))
        if log:
            return self._record(name, float(math.exp(
                self.rng.uniform(math.log(low), math.log(high)))))
        if step:
            # round, not truncate: (0.5-0.1)/0.1 floats to 3.9999…, and
            # int() would silently drop `high` from the search space
            n = int(round((high - low) / step))
            return self._record(name, low + step * int(self.rng.integers(n + 1)))
        return self._record(name, float(self.rng.uniform(low, high)))

    suggest_uniform = suggest_float
    suggest_loguniform = None  # defined below


def _suggest_loguniform(self, name, low, high):
    return self.suggest_float(name, low, high, log=True)


Trial.suggest_loguniform = _suggest_loguniform


def suggest_from_spec(trial, name: str, spec: Dict[str, Any]):
    """Apply one reference-format suggest spec
    (reference: train_config.py:53-72)."""
    fn = getattr(trial, spec["type"])
    args = [name] + list(spec["args"])
    kwargs = dict(spec.get("kwargs", {}))
    return fn(*args, **kwargs)


def hyperparams_from_config(run_config, trial) -> Dict[str, Any]:
    """fixed dict + sampled search values (reference: train_config.py:74-86)."""
    hyp = dict(run_config.hyperparams_fix)
    for k, spec in run_config.hyperparams_optuna.items():
        hyp[k] = suggest_from_spec(trial, k, spec)
    return hyp


# The reference's protocol searched hyperparameters PER channel subset and
# kept per-channel winner files (best_model_hyperparameters/<task>/
# {N,S,P,all}_*.json) — channel selection was part of its search, outside
# optuna. Round-3 measurements showed the subset dominates everything else
# (coreness5k_s53: frozen-S 0.880 vs searched-NSP 0.612), so here the subset
# is a first-class categorical hyperparameter instead.
CHANNEL_SUBSETS = ("S", "N", "P", "NS", "SP", "NP", "NSP")


def suggest_channels(trial, subsets=CHANNEL_SUBSETS) -> Dict[str, Any]:
    """Suggest the active channel subset as one categorical and return the
    three HParams toggles. Callers gate channel-specific suggests on the
    returned flags so TPE sees channel-conditional subspaces (a parameter
    absent from a trial is simply skipped by the univariate estimator)."""
    sub = trial.suggest_categorical("channel_subset", list(subsets))
    return {"use_neighborhood": "N" in sub,
            "use_structure": "S" in sub,
            "use_position": "P" in sub}


def _grid_points(space: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
    keys = list(space)
    points: List[Dict[str, Any]] = [{}]
    for k in keys:
        points = [dict(p, **{k: v}) for p in points for v in space[k]]
    return points


class TPESampler:
    """Univariate Tree-structured Parzen Estimator, the reference's default
    sampler (reference: train_config.py:28,255-262 uses
    optuna.samplers.TPESampler when the config names neither grid nor
    random). Per parameter: split completed trials into the top `gamma`
    quantile ("good") and the rest, model each side with a Gaussian KDE
    (category frequencies for categoricals), draw candidates from the good
    model and keep the one maximizing the good/bad density ratio. The
    first `n_startup` trials fall back to random (hook returns None)."""

    def __init__(self, direction: str = "maximize", n_startup: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.direction = direction
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.trials: List[Dict[str, Any]] = []  # bound by Study

    def _split(self, name):
        hist = [(t["params"][name], t["value"]) for t in self.trials
                if name in t.get("params", {})
                and np.isfinite(t.get("value", float("nan")))]
        if len(hist) < self.n_startup:
            return None, None
        hist.sort(key=lambda kv: kv[1], reverse=self.direction == "maximize")
        n_good = max(2, int(math.ceil(self.gamma * len(hist))))
        if len(hist) - n_good < 2:
            return None, None
        good = [h[0] for h in hist[:n_good]]
        bad = [h[0] for h in hist[n_good:]]
        return good, bad

    @staticmethod
    def _log_kde(x, centers, bw):
        # bw: scalar or per-center array (the uniform-prior pseudo-center
        # carries a range-wide bandwidth)
        bw = np.broadcast_to(np.asarray(bw, float), centers.shape)
        d = (x[:, None] - centers[None, :]) / bw[None, :]
        dens = np.mean(np.exp(-0.5 * d * d) / bw[None, :], axis=1)
        return np.log(dens + 1e-300)

    def propose(self, name, kind, meta, rng):
        good, bad = self._split(name)
        if good is None:
            return None
        if kind == "categorical":
            choices = meta["choices"]

            def weights(vals):
                c = np.array([sum(1 for v in vals if v == ch)
                              for ch in choices], float) + 1.0
                return c / c.sum()

            wg, wb = weights(good), weights(bad)
            cand = rng.choice(len(choices), size=self.n_candidates, p=wg)
            best = cand[int(np.argmax((wg / wb)[cand]))]
            return choices[int(best)]

        low, high, log = meta["low"], meta["high"], meta.get("log", False)
        xform = (lambda v: math.log(v)) if log else (lambda v: float(v))
        lo, hi = xform(low), xform(high)
        g = np.array([xform(v) for v in good])
        b = np.array([xform(v) for v in bad])

        def bw(data):
            s = float(np.std(data))
            return max(s * len(data) ** -0.2, (hi - lo) / 100.0, 1e-12)

        bw_g, bw_b = bw(g), bw(b)
        # optuna-style uniform prior component: one pseudo-center at the
        # range midpoint with range-wide bandwidth, mixed into the good KDE
        # for BOTH candidate draws and both density scores. Without it
        # (and with clipping instead of reflection below) a good trial at
        # a bound creates an absorbing atom: clipped draws stack exactly
        # ON the bound, the density ratio peaks there, and the sampler
        # proposes the identical config forever — measured on the round-4
        # coreness attempt-4 study, where ~20 of 48 trials were the same
        # all-bounds corner point (RESULTS.md round 4)
        mid, wide = (lo + hi) / 2.0, max(hi - lo, 1e-12)
        g_prior = np.append(g, mid)
        b_prior = np.append(b, mid)
        pick = rng.integers(len(g_prior), size=self.n_candidates)
        centers = g_prior[pick]
        widths = np.where(pick == len(g), wide, bw_g)
        cand = centers + rng.normal(size=self.n_candidates) * widths
        # reflect at the bounds instead of clipping (no boundary atom)
        span = hi - lo
        if span > 0:
            cand = np.abs((cand - lo) % (2 * span))
            cand = lo + np.where(cand > span, 2 * span - cand, cand)
        else:
            cand = np.full_like(cand, lo)
        bwg_arr = np.append(np.full(len(g), bw_g), wide)
        bwb_arr = np.append(np.full(len(b), bw_b), wide)
        score = (self._log_kde(cand, g_prior, bwg_arr)
                 - self._log_kde(cand, b_prior, bwb_arr))
        x = float(cand[int(np.argmax(score))])
        return math.exp(x) if log else x


def _pid_alive(pid: int) -> bool:
    """True if a process with this pid exists (signal-0 probe)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class Study:
    """Random/grid search with a resumable JSON state file."""

    def __init__(self, study_path: str | Path, direction: str = "maximize",
                 sampler: str = "random", seed: int = 0,
                 grid_search_space: Optional[Dict[str, List[Any]]] = None):
        self.path = Path(study_path)
        self.direction = direction
        self.sampler = sampler
        self.seed = seed
        self.grid = (_grid_points(grid_search_space)
                     if sampler == "grid" and grid_search_space else None)
        # like the reference, any sampler name other than grid/random means
        # TPE (reference: train_config.py:255-262)
        self.tpe = (TPESampler(direction=direction)
                    if sampler not in ("grid", "random") else None)
        self.trials: List[Dict[str, Any]] = []
        # clear stale temp files left by a kill between write and rename —
        # but ONLY those whose embedded PID is no longer alive: another
        # process racing on this study dir (the round-3 hazard) may be
        # between write_text and replace on its own temp right now
        for stale in self.path.parent.glob(self.path.name + ".*.tmp"):
            pid_part = stale.name[len(self.path.name) + 1:-len(".tmp")]
            if pid_part.isdigit() and _pid_alive(int(pid_part)):
                continue
            with contextlib.suppress(OSError):
                stale.unlink()
        if self.path.exists():
            self.trials = json.loads(self.path.read_text())["trials"]
        if self.tpe is not None:
            self.tpe.trials = self.trials

    def _save(self):
        if not is_lead():   # one writer a multi-rank run: rank 0
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # write-temp-then-rename: _save runs after EVERY trial, and study
        # files are snapshotted/copied by external harvesters (scripts/
        # harvest_watchdog.sh) — an in-place truncate-and-write would let a
        # concurrent copy (or a kill mid-write) capture truncated JSON
        # PID-suffixed so two processes racing on one study dir (the
        # documented round-3 hazard) cannot rename each other's partial
        # writes; Study.__init__ sweeps any stale leftovers
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps({"trials": self.trials}, indent=2,
                                  default=float))
        tmp.replace(self.path)

    def optimize(self, objective: Callable[[Trial], float], n_trials: int):
        start = len(self.trials)
        if self.grid is not None:
            # optuna's GridSampler stops the study once every grid point
            # has run — never re-run duplicate points
            n_trials = min(n_trials, len(self.grid))
        for t in range(start, n_trials):
            rng = np.random.default_rng([self.seed, t])
            fixed = self.grid[t % len(self.grid)] if self.grid else None
            trial = Trial(rng, fixed, study=self,
                          sampler_hook=(self.tpe.propose if self.tpe
                                        else None))
            pruned = False
            try:
                value = objective(trial)
            except TrialPruned:
                pruned = True
                vals = trial.intermediate.values()
                value = ((max(vals) if self.direction == "maximize"
                          else min(vals)) if vals else float("nan"))
            self.trials.append({
                "number": t, "value": float(value), "params": trial.params,
                "pruned": pruned,
                "intermediate": {str(k): v
                                 for k, v in trial.intermediate.items()},
                **({"attrs": trial.attrs} if trial.attrs else {})})
            self._save()
        return self

    @property
    def best_trial(self) -> Dict[str, Any]:
        # optuna semantics: only COMPLETE trials compete — a pruned trial's
        # recorded value is its best intermediate at prune time, not a
        # trained-out result
        complete = [t for t in self.trials if not t.get("pruned")]
        if not complete:
            raise ValueError("no completed trials in the study")

        def key(t):
            v = t["value"]
            if not np.isfinite(v):
                return float("-inf")
            return v if self.direction == "maximize" else -v
        return max(complete, key=key)

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial["params"]
