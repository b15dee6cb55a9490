"""The port's serving stack against the reference's on the same weights:
engine prefill logs and per-step logits, and ``ServingLoop`` token
streams — greedy, speculative, diffusion and MTP (on one MTP head bank
in both stacks), dense and paged (with a prefix hit),
the port's kernel flag on and off (its plain versions on the CPU), and a
preemption with recompute-on-resume — for a dense model (reduced
stablelm_3b) and an MoE one (reduced granite_moe_3b_a800m, whose kernel
flag also runs the grouped FFN's plain version in every forward).

Weights and caches are float32: the point is the algorithm, and there
the two stacks agree to float32 rounding, so streams must be identical.
(In bf16, XLA may keep excess precision between fused ops, which torch
cannot reproduce; streams of a random-weight model then part at argmax
near-ties.)  The reference engine's paged prefill builds its scratch
cache through ``init_cache``'s bf16 default, so the tests substitute a
float32 ``init_cache`` there.  Both stacks budget with the same numbers:
the port's HardwareSpec is built from the reference's TPU_V5E fields."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as ref_engine_mod  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.transformer import init_paged_cache as ref_paged  # noqa: E402
from repro.serving import AdmissionRejected as RefRejected  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import PagedKVConfig as RefPaged  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro.serving import init_mtp_heads as ref_init_heads  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models import init_model as port_init_model  # noqa: E402
from repro_torch.serving import (AdmissionConfig, AdmissionRejected,  # noqa: E402
                                 DecodeEngine, PagedKVConfig, ServingLoop)
from repro_torch.serving.spans import untimed  # noqa: E402

MAX_LEN, SLOTS, TOKENS = 128, 2, 10
MODES = ["greedy", "speculative", "diffusion", "mtp"]
# modes whose streams equal greedy decoding (diffusion's are its own)
LOSSLESS = ("greedy", "speculative", "mtp")
PAGES = [0, 16]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # float32 rounding, two layers
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))


@pytest.fixture(scope="module",
                params=["stablelm_3b", "granite_moe_3b_a800m"],
                ids=["stablelm", "granite"])
def model(request):
    cfg = get_config(request.param, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    heads = ref_init_heads(jax.random.PRNGKey(5), cfg.d_model,
                           cfg.vocab_size, n_heads=4, dtype=jnp.float32)
    HEADS[cfg.name] = (heads,
                       params_from_jax(jax.tree.map(np.asarray, heads)))
    return cfg, port_config(request.param, reduced=True), params, port


#: model name -> (reference MTP head bank, the same bank for the port)
HEADS = {}


def _mode_kw(cfg, mode, port=False):
    """ServingLoop arguments of ``mode``: the MTP bank (the mtp mode), a
    diffusion block of 4 refined in 2 forwards."""
    if mode == "mtp":
        return {"mtp_heads": HEADS[cfg.name][int(port)]}
    if mode == "diffusion":
        return {"block_size": 4, "refine_steps": 2}
    return {}


def _prompts(vocab):
    """Six prompts; the last shares its first 16 tokens (one 16-position
    page) with the second and is admitted later, so paged runs hit."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(4, 14)))
               for _ in range(4)]
    shared = rng.integers(0, vocab, size=20)
    prompts.insert(1, shared)
    prompts.append(np.concatenate([shared[:16], rng.integers(0, vocab, 5)]))
    return prompts


def _ref_engine(cfg, params, block_size):
    if block_size:
        n_phys = SLOTS * MAX_LEN // block_size + 1
        return RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                         paged=RefPaged(block_size=block_size),
                         cache=ref_paged(cfg, n_phys, block_size,
                                         dtype=jnp.float32))
    return RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                     cache=ref_init_cache(cfg, SLOTS, MAX_LEN,
                                          dtype=jnp.float32))


def _port_engine(pcfg, port, block_size, use_kernel=False):
    return DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN, hardware=HW,
                        use_kernel=use_kernel, device="cpu",
                        paged=(PagedKVConfig(block_size=block_size)
                               if block_size else None))


@pytest.fixture
def f32_scratch(monkeypatch):
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))


@pytest.fixture(scope="module")
def ref_runs(model):
    """Reference streams, stats and prefill logs per (mode, page size)."""
    cfg, _, params, _ = model
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "init_cache",
                   functools.partial(ref_init_cache, dtype=jnp.float32))
        for mode in MODES:
            for bs in PAGES:
                eng = _ref_engine(cfg, params, bs)
                loop = RefLoop(eng, mode=mode, **_mode_kw(cfg, mode))
                for p in _prompts(cfg.vocab_size):
                    loop.submit(p, TOKENS)
                out[mode, bs] = (loop.run(), loop.stats(), eng.prefill_log)
    return out


def _drive(loop, prompts, preempt_at=None):
    """Serve by hand; after ``preempt_at`` decode steps evict the lowest
    active slot mid-stream and let it resume by recompute."""
    for p in prompts:
        loop.submit(p, TOKENS)
    steps = 0
    while True:
        loop.admit()
        if preempt_at is not None and steps == preempt_at and loop.active:
            victim = loop.active[min(loop.active)]
            assert 0 < len(victim.generated) < victim.max_tokens
            loop.preempt(min(loop.active))
            loop.admit()
        if not loop.step():
            break
        steps += 1
    return {rid: r.tokens() for rid, r in sorted(loop.finished.items())}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("bs", PAGES, ids=["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
def test_streams_match_reference(model, ref_runs, mode, bs, use_kernel):
    cfg, pcfg, _, port = model
    want, want_stats, want_log = ref_runs[mode, bs]
    eng = _port_engine(pcfg, port, bs, use_kernel)
    loop = ServingLoop(eng, mode=mode, **_mode_kw(cfg, mode, port=True))
    for p in _prompts(cfg.vocab_size):
        loop.submit(p, TOKENS)
    got = loop.run()
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    assert untimed(eng.prefill_log) == want_log
    stats = loop.stats()
    for key in ("requests", "tokens", "forwards", "positions",
                "max_positions_per_forward", "prefill_forwards",
                "prefill_buckets", "prefill_positions_computed"):
        assert stats[key] == want_stats[key], key
    if bs:
        assert stats["prefix_hits"] == want_stats["prefix_hits"] >= 1
        assert stats["prefill_positions_saved"] == \
            want_stats["prefill_positions_saved"]
    if use_kernel:
        assert stats["kv_tiles_executed"] > 0


@pytest.mark.parametrize("bs", PAGES, ids=["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
def test_preemption_resumes_reference_streams(model, ref_runs, mode, bs):
    """Evict + recompute-on-resume is invisible in the lossless streams.
    A diffusion stream depends on its blocks, which the eviction moves:
    there the reference loop is driven through the same preemption."""
    cfg, pcfg, params, port = model
    loop = ServingLoop(_port_engine(pcfg, port, bs), mode=mode,
                       **_mode_kw(cfg, mode, port=True))
    got = _drive(loop, _prompts(cfg.vocab_size), preempt_at=2)
    assert loop.preempted_total >= 1 and loop.resumed_total >= 1
    if mode in LOSSLESS:
        want = ref_runs[mode, bs][0]
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_engine_mod, "init_cache",
                       functools.partial(ref_init_cache, dtype=jnp.float32))
            want = _drive(RefLoop(_ref_engine(cfg, params, bs), mode=mode,
                                  **_mode_kw(cfg, mode)),
                          _prompts(cfg.vocab_size), preempt_at=2)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("bs", PAGES, ids=["dense", "paged"])
def test_engine_prefill_and_step_logits(model, f32_scratch, bs):
    """Lock-step engines: admission prefill (with a prefix hit on the
    paged engine), then decode steps of width 3 with ragged commits."""
    cfg, pcfg, params, port = model
    ref, eng = _ref_engine(cfg, params, bs), _port_engine(pcfg, port, bs)
    prompts = _prompts(cfg.vocab_size)
    for group in ({0: prompts[1], 1: prompts[0]}, None, {0: prompts[5]}):
        if group is None:                      # retire slot 0, re-admit
            ref.release_slot(0)
            eng.release_slot(0)
            continue
        want = ref.prefill_slots(group)
        got = eng.prefill_slots(group)
        for s in group:
            np.testing.assert_allclose(_np(got[s][0]), _np(want[s][0]),
                                       **LOGIT_TOL)
            np.testing.assert_allclose(_np(got[s][1]), _np(want[s][1]),
                                       **LOGIT_TOL)
        assert eng.prefill_log == ref.prefill_log
        np.testing.assert_array_equal(eng.slot_lens_host, ref.slot_lens_host)
        rng = np.random.default_rng(len(ref.prefill_log))
        for step in range(3):
            toks = rng.integers(0, cfg.vocab_size, (SLOTS, 3))
            rl, rc, rh = ref.decode_slots(jnp.asarray(toks, jnp.int32))
            pl, pc, ph = eng.decode_slots(torch.as_tensor(toks))
            np.testing.assert_allclose(_np(pl), _np(rl), **LOGIT_TOL)
            np.testing.assert_allclose(_np(ph), _np(rh), **LOGIT_TOL)
            adv = np.array([3, step % 2])
            ref.commit_slots(rc, adv)
            eng.commit_slots(pc, adv)
    if bs:
        assert eng.manager.stats() == ref.manager.stats()
        assert eng.manager.stats()["prefix_hits"] >= 1


def test_greedy_generate_is_the_oracle(model, ref_runs):
    """The solo greedy driver matches the reference's, and every served
    stream of a lossless mode (both caches) equals its request decoded
    alone."""
    cfg, pcfg, params, port = model
    ref = RefEngine(cfg, params, batch=1, max_len=MAX_LEN,
                    cache=ref_init_cache(cfg, 1, MAX_LEN, dtype=jnp.float32))
    eng = DecodeEngine(pcfg, port, batch=1, max_len=MAX_LEN, hardware=HW,
                       device="cpu")
    for rid, prompt in enumerate(_prompts(cfg.vocab_size)):
        ref.cache = ref_init_cache(cfg, 1, MAX_LEN, dtype=jnp.float32)
        want = np.asarray(ref.greedy_generate(
            jnp.asarray(prompt[None], jnp.int32), TOKENS))[0]
        got = eng.greedy_generate(torch.as_tensor(prompt[None]),
                                  TOKENS)[0].numpy()
        np.testing.assert_array_equal(got, want)
        for (mode, _), (streams, _, _) in ref_runs.items():
            if mode in LOSSLESS:
                np.testing.assert_array_equal(streams[rid], got)


def test_backpressure_raises_the_ports_own_rejection(model):
    cfg, pcfg, _, port = model
    loop = ServingLoop(_port_engine(pcfg, port, 0),
                       admission=AdmissionConfig(max_waiting=2))
    p = _prompts(cfg.vocab_size)[0]
    loop.submit(p, 4)
    loop.submit(p, 4)
    with pytest.raises(AdmissionRejected):
        loop.submit(p, 4)
    assert loop.rejected_total == 1 and len(loop.waiting) == 2
    assert not issubclass(AdmissionRejected, RefRejected)
    loop = ServingLoop(_port_engine(pcfg, port, 0))
    with pytest.raises(ValueError, match="unknown SLO class"):
        loop.submit(p, 4, slo_class="platinum")
    with pytest.raises(ValueError, match="exceeds the engine's max_len"):
        loop.submit(np.arange(MAX_LEN + 1) % cfg.vocab_size, 1)
    with pytest.raises(ValueError, match="cannot fit"):
        loop.submit(np.arange(MAX_LEN - 4) % cfg.vocab_size, 8)


def test_priority_admission_and_preemption(model):
    """An interactive arrival admits ahead of an earlier batch request,
    and on a 3-block pool it preempts the batch resident; both streams
    still equal their solo greedy decodes."""
    cfg, pcfg, _, port = model
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=12) for _ in range(2)]
    solo = DecodeEngine(pcfg, port, batch=1, max_len=MAX_LEN, hardware=HW,
                        device="cpu")
    refs = [solo.greedy_generate(torch.as_tensor(p[None]), TOKENS)[0].numpy()
            for p in prompts]
    loop = ServingLoop(_port_engine(pcfg, port, 0), mode="greedy")
    loop.free_slots = [0]                      # one slot: order decides
    first = loop.submit(prompts[0], 4, slo_class="batch")
    second = loop.submit(prompts[1], 4, slo_class="interactive")
    loop.admit()
    assert [r.rid for r in loop.active.values()] == [second.rid]
    assert [r.rid for r in loop.waiting] == [first.rid]

    eng = DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN,
                       hardware=HW, device="cpu",
                       paged=PagedKVConfig(block_size=16, n_blocks=3))
    loop = ServingLoop(eng, admission=AdmissionConfig(preemption=True))
    loop.submit(prompts[0], TOKENS, slo_class="batch")
    loop.admit()
    loop.step()
    loop.submit(prompts[1], TOKENS, slo_class="interactive")
    loop.admit()
    assert loop.preempted_total == 1
    assert next(iter(loop.waiting)).slo_class == "batch"
    while True:
        loop.admit()
        if not loop.step():
            break
    for rid in (0, 1):
        np.testing.assert_array_equal(loop.finished[rid].tokens(), refs[rid])
    assert loop.resumed_total == 1


@pytest.mark.parametrize("mode", ["speculative", "diffusion", "mtp"])
def test_ssm_engine_refuses_multi_position_modes(mode):
    """Every mode but greedy runs multi-position forwards over rejected or
    masked positions, which a recurrent state would take in: an SSM
    engine refuses them all."""
    pcfg = port_config("falcon_mamba_7b", reduced=True)
    port = port_init_model(pcfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    eng = DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN,
                       hardware=HW, device="cpu")
    with pytest.raises(ValueError, match="recurrent SSM state"):
        ServingLoop(eng, mode=mode, mtp_heads={"heads": torch.zeros(
            (2, pcfg.d_model, pcfg.vocab_size))})
