"""Elastic / fault-tolerant training primitives.

Three pieces the launchers compose:

  - ``elastic_mesh``:     pick a mesh factorization for however many
                          devices the (possibly degraded) fleet has,
  - ``StepWatchdog``:     flag persistent stragglers from step latencies,
  - ``run_with_restarts``: drive a step function with
                          restore-from-checkpoint recovery on failure.

Framework-free: a copy of the reference's ``dist/elastic.py``, plus
``UpdateInterrupted``, which ``run_with_restarts`` rolls back instead of
retrying in place.  The launcher (``launch/train.py``) runs one card,
whose mesh is (1, 1).
"""
from __future__ import annotations

from typing import Callable, Tuple

POD_CHIPS = 256          # one pod = 16 x 16 chips
POD_SHAPE = (16, 16)
MAX_MODEL_AXIS = 16


def elastic_mesh(n_devices: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Mesh factorization for an elastic fleet of ``n_devices`` chips.

    Full multiples of a pod keep the production (pod, data, model) /
    (data, model) layouts; a degraded fleet (node failures removed some
    hosts) falls back to the largest model axis <= 16 that divides the
    device count, with everything else on the data axis.
    """
    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if n_devices > POD_CHIPS and n_devices % POD_CHIPS == 0:
        return ((n_devices // POD_CHIPS, *POD_SHAPE),
                ("pod", "data", "model"))
    if n_devices == POD_CHIPS:
        return (POD_SHAPE, ("data", "model"))
    model = max(d for d in range(1, min(MAX_MODEL_AXIS, n_devices) + 1)
                if n_devices % d == 0)
    return ((n_devices // model, model), ("data", "model"))


class StepWatchdog:
    """Flags a persistent straggler: ``observe(dt)`` returns True once
    ``max_misses`` consecutive steps exceeded the deadline.

    A single slow step (compile, checkpoint flush, transient network
    stall) is normal; consecutive misses mean a degraded host that the
    launcher should restart away from.
    """

    def __init__(self, deadline_s: float, max_misses: int = 2):
        self.deadline_s = float(deadline_s)
        self.max_misses = int(max_misses)
        self.misses = 0
        self.observed = 0

    def observe(self, step_seconds: float) -> bool:
        self.observed += 1
        if step_seconds > self.deadline_s:
            self.misses += 1
        else:
            self.misses = 0
        return self.misses >= self.max_misses


class UpdateInterrupted(RuntimeError):
    """A step failed after its update began to change the state in place
    (the port's AdamW writes leaf by leaf; the loss readback and the
    checkpoint snapshot follow the update).  Running the step again would
    apply the update on top of itself, so ``run_with_restarts`` never
    retries it in place: it rolls back."""


def run_with_restarts(step_fn: Callable[[int], None], start: int,
                      total: int, restore_fn: Callable[[], int], *,
                      retry_transient: bool = True,
                      max_restarts: int = 8) -> int:
    """Run ``step_fn(step)`` for ``step in [start, total)`` with
    restore-and-resume recovery.

    On an exception the step is optionally retried once in place
    (``retry_transient`` — covers flaky I/O without paying a rollback),
    unless it is an ``UpdateInterrupted``; if it fails again (or was
    interrupted mid-update), ``restore_fn()`` rolls state back to the
    last checkpoint and returns the step to resume from.  More than
    ``max_restarts`` rollbacks re-raises: the failure is deterministic
    and restarting cannot help.
    """
    step = start
    restarts = 0
    while step < total:
        try:
            step_fn(step)
        except Exception as exc:
            if retry_transient and not isinstance(exc, UpdateInterrupted):
                try:
                    step_fn(step)
                    step += 1
                    continue
                except Exception:
                    pass
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_fn()
            continue
        step += 1
    return total
