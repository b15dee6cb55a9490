"""The captured forwards against the eager ones on the card: for each
ported model (reduced, bf16, through the kernels), a ``capture=True``
engine must give logits and hidden states BITWISE equal to a
``capture=False`` engine holding the same weights and cache:
``decode_slots`` at widths 1, 5, 16 and 17, dense and paged (the SSM and
hybrid models dense, their committed states compared too), step after
step with commits between; ``prefill_slots`` over the (batch, width)
grid, every slot at once and then two re-admitted (paged: one of them a
prefix hit), every cache tensor and the slot lengths compared; and the
single-request ``greedy_generate`` and ``peek_step`` / ``commit`` /
``decode_step``.  The kernel launch counters must advance by exactly the
eager forward's launches per replay, the capture itself counting none.

Needs an NVIDIA GPU (marker ``gpu``; skipped elsewhere) and imports no
JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_capture.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

ARCHS = ["stablelm_3b", "granite_moe_3b_a800m", "falcon_mamba_7b",
         "wedlm8b_like", "llada_mini_like", "zamba2_1p2b"]
WIDTHS = (1, 5, 16, 17)
SLOTS, MAX_LEN = 4, 128


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture device work")


def _engines(arch, paged, prefill=True):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.transformer import has_ssm
    from repro_torch.serving import DecodeEngine, PagedKVConfig
    cfg = get_config(arch, reduced=True)
    if paged and has_ssm(cfg):
        pytest.skip("an SSM model serves on the dense cache only")
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    kv = PagedKVConfig(block_size=16) if paged else None
    rng = np.random.default_rng(1)
    prompts = {s: rng.integers(0, cfg.vocab_size, size=9 + 5 * s)
               for s in range(SLOTS)}
    engines = []
    for capture in (False, True):
        eng = DecodeEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                           paged=kv, device="cuda", capture=capture)
        if prefill:
            eng.prefill_slots(prompts)
        engines.append(eng)
    return cfg, engines


def _state(eng):
    """Every cache tensor, a hybrid segment's nested ones included."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree
    return [t.clone() for seg in eng.cache["segments"] for t in leaves(seg)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_decode_equals_eager(arch, paged):
    _need_card()
    from repro_torch.serving.capture import launch_counts
    cfg, (eager, captured) = _engines(arch, paged)
    rng = np.random.default_rng(2)
    for n in WIDTHS:
        for step in range(2):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                size=(SLOTS, n)),
                                   device="cuda")
            counts = []
            outs = []
            for eng in (eager, captured):
                before = launch_counts()
                logits, cache, hidden = eng.decode_slots(toks)
                torch.cuda.synchronize()
                after = launch_counts()
                counts.append({k: after[k] - before[k] for k in after})
                outs.append((logits.clone(), hidden.clone()))
                adv = np.array([1 + (s + step) % n for s in range(SLOTS)])
                adv[step % SLOTS] = 0            # a row that keeps its state
                eng.commit_slots(cache, adv)
            assert counts[0] == counts[1], (n, step)
            assert sum(counts[0].values()) > 0
            assert torch.equal(outs[0][0], outs[1][0]), (n, step)
            assert torch.equal(outs[0][1], outs[1][1]), (n, step)
            for a, b in zip(_state(eager), _state(captured)):
                assert torch.equal(a, b), (n, step)
    assert sum(k[0] == "decode" for k in captured.graphs.steps) == len(WIDTHS)


def _calls(engines, fn):
    """``fn(engine)`` on each engine: (outputs, every cache tensor and the
    slot lengths, the launches the call made) per engine."""
    from repro_torch.serving.capture import launch_counts
    out = []
    for eng in engines:
        before = launch_counts()
        got = fn(eng)
        torch.cuda.synchronize()
        after = launch_counts()
        out.append((got, _state(eng) + [eng.slot_lens.clone()],
                    {k: after[k] - before[k] for k in after}))
    return out


def _same(results):
    (a, sa, ca), (b, sb, cb) = results
    assert ca == cb
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_prefill_equals_eager(arch, paged):
    _need_card()
    cfg, engines = _engines(arch, paged, prefill=False)
    rng = np.random.default_rng(3)
    first = {s: rng.integers(0, cfg.vocab_size, size=20 + 3 * (s % 2))
             for s in range(SLOTS)}
    # slot 1's prompt shares one 16-position page with slot 0's
    second = {1: np.concatenate([first[0][:16],
                                 rng.integers(0, cfg.vocab_size, 5)]),
              3: rng.integers(0, cfg.vocab_size, 11)}

    def admit(group):
        def fn(eng):
            got = eng.prefill_slots(group)
            return [t for s in sorted(got) for t in got[s]]
        return fn

    def decode(n, adv):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            size=(SLOTS, n)), device="cuda")

        def fn(eng):
            logits, cache, hidden = eng.decode_slots(toks)
            out = [logits.clone(), hidden.clone()]
            eng.commit_slots(cache, adv)
            return out
        return fn
    _same(_calls(engines, admit(first)))
    _same(_calls(engines, decode(1, np.ones(SLOTS, np.int64))))
    for eng in engines:
        for s in second:
            eng.release_slot(s)
    _same(_calls(engines, admit(second)))
    if paged:
        assert [e["cached_tokens"] for e in engines[1].prefill_log] == [0,
                                                                        0, 16]
    _same(_calls(engines, decode(3, np.array([3, 1, 0, 3]))))
    _same(_calls(engines, decode(1, np.ones(SLOTS, np.int64))))
    kinds = {k[0] for k in engines[1].graphs.steps}
    assert kinds == {"prefill", "decode"}


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_single_request_equals_eager(arch):
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serving import DecodeEngine
    cfg = get_config(arch, reduced=True)
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    engines = [DecodeEngine(cfg, params, batch=1, max_len=MAX_LEN,
                            device="cuda", capture=c) for c in (True, False)]
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 13)),
                             device="cuda")
    draft = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 5)),
                            device="cuda")
    streams = [eng.greedy_generate(prompt, 8) for eng in engines]
    assert torch.equal(*streams)
    adv = 5 if engines[0].recurrent else 3

    def fn(eng):
        out = [eng.prefill(prompt).clone(), eng.last_hidden.clone()]
        logits, cache, hidden = eng.peek_step(draft)
        out += [logits.clone(), hidden.clone()]
        eng.commit(cache, adv)
        out.append(eng.decode_step(draft[:, :1]).clone())
        return out
    _same(_calls(engines, fn))
    assert engines[0].cache_len == engines[1].cache_len == 13 + adv + 1
    assert {k[0] for k in engines[0].graphs.steps} == {"prefill_single",
                                                       "decode_single"}
