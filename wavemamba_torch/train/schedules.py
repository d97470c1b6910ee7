"""Learning-rate schedules as closed-form functions `step -> lr` (Python
floats), step counted from 0: the first update uses `schedule(0)`, as optax
does. The counterpart of `wavemamba_tpu/train/schedules.py`.

  * cosine_annealing_restart_cyclic  each cycle has its own eta_min (the
    schedule of `options/train_wavemamba_uhdll.yml`)
  * cosine_annealing_restart
  * multistep_restart
"""

from __future__ import annotations

import itertools
import math


def _period_index(cumulative, step):
    """Index of the period that holds `step`. A step exactly on a restart
    boundary still belongs to the old period (lr = eta_min there, not the
    restarted peak)."""
    return min(sum(step > c for c in cumulative), len(cumulative) - 1)


def cosine_annealing_restart_cyclic(base_lr, periods, restart_weights=None, eta_mins=None):
    """Cosine annealing with restarts; each cycle has its own eta_min."""
    restart_weights = restart_weights or [1.0] * len(periods)
    eta_mins = eta_mins or [0.0] * len(periods)
    if not len(periods) == len(restart_weights) == len(eta_mins):
        raise ValueError("periods, restart_weights and eta_mins must have one entry per cycle")
    cumulative = list(itertools.accumulate(periods))
    starts = [0] + cumulative[:-1]

    def schedule(step):
        idx = _period_index(cumulative, step)
        eta = eta_mins[idx]
        frac = (step - starts[idx]) / periods[idx]
        return eta + restart_weights[idx] * 0.5 * (base_lr - eta) * (1.0 + math.cos(math.pi * frac))

    return schedule


def cosine_annealing_restart(base_lr, periods, restart_weights=None, eta_min=0.0):
    n = len(periods)
    return cosine_annealing_restart_cyclic(
        base_lr, periods, restart_weights or [1.0] * n, [eta_min] * n
    )


def multistep_restart(base_lr, milestones, gamma=0.1, restarts=(0,), restart_weights=(1,)):
    """Step decay at the milestones; lr goes back to base * weight at a restart."""
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights must have the same length")
    milestones = sorted(milestones)
    restarts_a = sorted(zip(restarts, restart_weights))

    def schedule(step):
        w, last_restart = 1.0, 0
        for r, rw in restarts_a:  # the most recent restart at or before `step`
            if step >= r:
                w, last_restart = float(rw), r
        decays = sum(1 for m in milestones if step >= m and m > last_restart)
        return base_lr * w * gamma**decays

    return schedule


def with_warmup(lr, warmup_iter):
    """Linear warm-up over the first `warmup_iter` steps towards `lr`, a
    number or a schedule."""

    def schedule(step):
        target = lr(step) if callable(lr) else lr
        if step < warmup_iter:
            return target * min(step + 1, warmup_iter) / warmup_iter
        return target

    return schedule


def build_scheduler(opt: dict, base_lr: float):
    """YAML scheduler opt -> schedule function."""
    opt = dict(opt)
    name = opt.pop("type")
    if name == "CosineAnnealingRestartCyclicLR":
        return cosine_annealing_restart_cyclic(
            base_lr, opt["periods"], opt.get("restart_weights"), opt.get("eta_mins")
        )
    if name == "CosineAnnealingRestartLR":
        return cosine_annealing_restart(
            base_lr, opt["periods"], opt.get("restart_weights"), opt.get("eta_min", 0.0)
        )
    if name == "MultiStepLR" or name == "MultiStepRestartLR":
        return multistep_restart(
            base_lr,
            opt.get("milestones", []),
            opt.get("gamma", 0.1),
            tuple(opt.get("restarts", (0,))),
            tuple(opt.get("restart_weights", (1,))),
        )
    raise KeyError(f"Unknown scheduler type {name!r}")
