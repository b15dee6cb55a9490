"""The captured decode step against the eager one on the card: for each
ported model (reduced, bf16, through the kernels), ``decode_slots`` of a
``capture=True`` engine must give logits and hidden states BITWISE equal
to a ``capture=False`` engine holding the same weights and cache, at
widths 1, 5, 16 and 17, dense and paged (the SSM model dense, its
committed state compared too), step after step with commits between;
and the kernel launch counters must advance by exactly the eager
forward's launches per replay, the capture itself counting none.

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
         "wedlm8b_like", "llada_mini_like"]
WIDTHS = (1, 5, 16, 17)
SLOTS, MAX_LEN = 4, 128


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture device work")


def _engines(arch, paged):
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
        eng.prefill_slots(prompts)
        engines.append(eng)
    return cfg, engines


def _state(eng):
    return [t.clone() for seg in eng.cache["segments"] for t in seg.values()]


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
    assert len(captured.graphs.steps) == len(WIDTHS)
