"""The traffic generator: the same seed gives the same requests, every
seed the same set of sizes in its own order."""
import numpy as np
import pytest

from bench import harness, loadgen

MIXES = ["long_answer_c16", "long_answer_c40", "long_prompt_c16"]


def _requests(t, seed, n_rounds=3, vocab=50304):
    return [loadgen.request(t, seed, vocab, c, i)
            for i in range(n_rounds) for c in range(t["clients"])]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    t = harness.traffic(mix)
    a, b = _requests(t, 2 ** 31 + 5), _requests(t, 2 ** 31 + 5)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    streams = loadgen.client_streams(t, 2 ** 31 + 5, 50304)
    first = [next(s) for s in streams]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(first, a[:t["clients"]]))


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_same_sizes_in_its_own_order(mix):
    t = harness.traffic(mix)
    c = t["clients"]
    seqs = {}
    for seed in (1, 2 ** 31 + 11, 2 ** 33 + 7):
        reqs = _requests(t, seed, n_rounds=4)
        # each client's sequence of (prompt, output) sizes
        seqs[seed] = [tuple((len(reqs[r * c + k][0]), reqs[r * c + k][1])
                            for r in range(4)) for k in range(c)]
        for r in range(4):
            block = reqs[r * c:(r + 1) * c]
            assert sorted(len(p) for p, _ in block) == sorted(
                loadgen.length_set(t["prompt_len"], c).tolist())
            assert sorted(o for _, o in block) == sorted(
                loadgen.length_set(t["output_len"], c).tolist())
    runs = list(seqs.values())
    # the same sequences, held by other clients
    assert all(sorted(s) == sorted(runs[0]) for s in runs)
    assert len({tuple(s) for s in runs}) > 1
    sizes = loadgen.length_set(t["prompt_len"], c)
    assert sizes.min() >= t["prompt_len"]["min"]
    assert sizes.max() <= t["prompt_len"]["max"]


def test_lengths_are_the_strata_midpoints():
    spec = {"median": 100, "sigma": 0.5, "min": 1, "max": 10 ** 6}
    sizes = loadgen.length_set(spec, 4)
    # midpoints of four equal-probability strata: z = +-0.3186, +-1.1503
    want = np.rint(100 * np.exp(0.5 * np.array(
        [-1.1503494, -0.3186394, 0.3186394, 1.1503494])))
    assert sizes.tolist() == want.astype(int).tolist()
    assert loadgen.length_set(spec, 5)[2] == 100


def test_prompt_buckets_cover_the_mix():
    t = harness.traffic("long_answer_c16")

    def bucket(p):
        b = 8
        while b < p:
            b *= 2
        return b
    assert loadgen.prompt_buckets(t, bucket) == [32, 64, 128, 256, 512]
    t = harness.traffic("long_prompt_c16")
    assert loadgen.prompt_buckets(t, bucket) == [256, 512, 1024, 2048]


def test_token_ids_stay_in_the_vocabulary():
    t = harness.traffic("long_answer_c40")
    for p, _ in _requests(t, 2 ** 40 + 3, n_rounds=1, vocab=49155):
        assert p.min() >= 0 and p.max() < 49155
