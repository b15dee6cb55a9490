"""The one general traffic generator: closed-loop clients from a traffic
file's parameters and the run's seed.

Lengths are clamped lognormals (``median``, ``sigma`` in log space,
``min`` / ``max``), as the port's ``loadgen.trace.LengthSpec`` draws
them, but stratified: in each round every one of the ``C`` clients gets
one of ``C`` fixed sizes, the midpoints of ``C`` equal-probability
strata. Which client gets which size in a round is a permutation drawn
from the fixed ``SCHEDULE`` (prompt and output lengths permuted apart),
so the clients' sequences of sizes are the same for every run seed; the
run's seed rotates them among the clients and draws the prompts' token
ids, uniform over the vocabulary, per (client, request). A closed loop's
clients are alike, so every seed does the same work in another order: a
window holds only some tens of requests, and sizes drawn anew per seed
made the work of a window differ by seed far more than the timing of one
seed did. A client's next request is its next round's.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

#: the seed of the rounds' permutations, the same for every run
SCHEDULE = 0


def length_set(spec: Dict, n: int) -> np.ndarray:
    """The ``n`` stratum midpoints of the clamped lognormal ``spec``."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *keys])


def request(traffic: Dict, seed: int, vocab: int, client: int,
            index: int) -> Tuple[np.ndarray, int]:
    """(prompt token ids, output length) of a client's ``index``-th
    request."""
    c = traffic["clients"]
    prompts = length_set(traffic["prompt_len"], c)
    outputs = length_set(traffic["output_len"], c)
    seat = (client + int(seed)) % c
    p = prompts[_rng(SCHEDULE, 1, index).permutation(c)[seat]]
    o = outputs[_rng(SCHEDULE, 2, index).permutation(c)[seat]]
    ids = _rng(seed, 3, client, index).integers(0, vocab, int(p))
    return ids.astype(np.int64), int(o)


def client_streams(traffic: Dict, seed: int, vocab: int
                   ) -> List[Iterator[Tuple[np.ndarray, int]]]:
    """One endless request stream per client."""
    def stream(client: int):
        index = 0
        while True:
            yield request(traffic, seed, vocab, client, index)
            index += 1
    return [stream(c) for c in range(traffic["clients"])]


def prompt_buckets(traffic: Dict, bucket) -> List[int]:
    """Every prefill bucket a prompt of the mix can reach."""
    sizes = length_set(traffic["prompt_len"], traffic["clients"])
    return sorted({bucket(int(p)) for p in sizes})
