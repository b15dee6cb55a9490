"""Faults planted under the timed path, to show that the check fails
them: the tests drive whole runs with each, and ``calibrate.py --fault``
reads them at a cell's own size.  A benchmark run plants none.

Serving (``hooks["engine"]`` takes the engine; ``altered_tokens`` is a
context manager around the run): a step whose state stays unchanged
(lengths never advance on the device), half of the batch left out (its
rows fed token 0), a token altered where it is produced (the decode
argmax shifted by one).  Training (``hooks["step_fn"]`` wraps the step
function): half of the batch left out, the mean taken over the rest; a
step that returns its state unchanged.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def state_unchanged(engine) -> None:
    def commit_slots(new_cache, advances):
        engine.slot_lens_host = engine.slot_lens_host + np.asarray(advances)
    engine.commit_slots = commit_slots


def half_batch(engine) -> None:
    inner = engine.decode_slots

    def decode_slots(tokens):
        tokens = tokens.clone()
        tokens[engine.batch // 2:] = 0
        return inner(tokens)
    engine.decode_slots = decode_slots


@contextlib.contextmanager
def altered_tokens():
    from repro_torch.serving import algorithm
    inner = algorithm.greedy_tokens

    def altered(logits):
        return ((torch.argmax(logits, -1) + 1) % logits.shape[-1]).to(
            torch.int32)
    algorithm.greedy_tokens = altered
    try:
        yield
    finally:
        algorithm.greedy_tokens = inner


def half_batch_step(fn):
    def step(params, opt, batch):
        half = batch["tokens"].shape[0] // 2
        return fn(params, opt, {"tokens": batch["tokens"][:half]})
    return step


def unchanged_step(cfg):
    """A step function that computes the loss and updates nothing."""
    def wrap(fn):
        from repro_torch.training.train_step import loss_fn

        def step(params, opt, batch):
            loss, _ = loss_fn(params, cfg, batch)
            return params, opt, {"loss": loss.detach()}
        return step
    return wrap


SERVING = {"state_unchanged": state_unchanged, "half_batch": half_batch}
TRAINING = {"half_batch": half_batch_step}
