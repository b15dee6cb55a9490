"""The port's diffusion and MTP serving and its single-request drivers
against the reference's, on the same float32 weights (and the same MTP
head bank) through ``params_from_jax``: reduced stablelm_3b (dense) and
reduced llada_mini_like (MoE, E = 16 top-2 at this size).

Counterparts of the reference's ``tests/test_serving_modes.py``: the
diffusion KV-commit rule (the committed K/V equal a prefill of the
resolved stream, and a commit of the last refinement forward's K/V fails
that comparison), batched diffusion / MTP against their solo drivers, the
MoE golden through the kernel flag (the port's plain versions on the CPU;
the reference's Pallas kernels in interpret mode), plus ``refine_block``'s
selection, ``mtp_propose``, ``peek_step`` / ``commit`` and the serve CLI.

Float32 throughout: there the two stacks agree to float32 rounding, so
streams and per-driver statistics must be identical.  The port writes
K/V in place and compares its committed K/V with a prefill's within
``KV_TOL``: a decode-shape forward and a prefill reach the same K/V
through products of other shapes, which the CPU's float32 GEMMs may sum
in another order."""
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
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import DiffusionBlockDecoder as RefDiffusion  # noqa: E402
from repro.serving import MTPDecoder as RefMTP  # noqa: E402
from repro.serving import PagedKVConfig as RefPaged  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro.serving import SpeculativeDecoder as RefSpeculative  # noqa: E402
from repro.serving import init_mtp_heads as ref_init_heads  # noqa: E402
from repro.serving.diffusion import refine_block as ref_refine  # noqa: E402
from repro.serving.mtp import mtp_propose as ref_propose  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.launch.serve import build_parser, serve  # noqa: E402
from repro_torch.models import init_model as port_init_model  # noqa: E402
from repro_torch.serving import (DecodeEngine, DiffusionBlockDecoder,  # noqa: E402
                                 MTPDecoder, PagedKVConfig, ServingLoop,
                                 SpeculativeDecoder, mtp_propose,
                                 refine_block)
from repro_torch.serving.diffusion import confidence  # noqa: E402

TOKENS, MAX_LEN = 10, 96
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
# committed K/V against a prefill's: float32 rounding of two layers
KV_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(arch, n_prompts):
    cfg = get_config(arch, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    prompts = [np.asarray(jax.random.randint(
        jax.random.PRNGKey(i + 1), (5 + i,), 0, cfg.vocab_size))
        for i in range(n_prompts)]
    heads = ref_init_heads(jax.random.PRNGKey(5), cfg.d_model,
                           cfg.vocab_size, n_heads=4, dtype=jnp.float32)
    return (cfg, port_config(arch, reduced=True), params, port, prompts,
            heads, params_from_jax(jax.tree.map(np.asarray, heads)))


@pytest.fixture(scope="module")
def dense_setup():
    return _setup("stablelm_3b", 4)


@pytest.fixture(scope="module")
def moe_setup():
    return _setup("llada_mini_like", 3)


@pytest.fixture(scope="module", params=["stablelm_3b", "llada_mini_like"],
                ids=["stablelm", "llada"])
def setup(request, dense_setup, moe_setup):
    return dense_setup if request.param == "stablelm_3b" else moe_setup


def _ref_engine(cfg, params, batch, use_kernel=False, block_size=0):
    if block_size:
        n_phys = batch * MAX_LEN // block_size + 1
        return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                         use_kernel=use_kernel,
                         paged=RefPaged(block_size=block_size),
                         cache=ref_paged(cfg, n_phys, block_size,
                                         dtype=jnp.float32))
    return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                     use_kernel=use_kernel,
                     cache=ref_init_cache(cfg, batch, MAX_LEN,
                                          dtype=jnp.float32))


def _port_engine(pcfg, port, batch, use_kernel=False, block_size=0):
    return DecodeEngine(pcfg, port, batch=batch, max_len=MAX_LEN,
                        hardware=HW, use_kernel=use_kernel, device="cpu",
                        paged=(PagedKVConfig(block_size=block_size)
                               if block_size else None))


@pytest.fixture
def f32_scratch(monkeypatch):
    """The reference's paged prefill builds its scratch cache through
    ``init_cache``'s bf16 default; hold it to float32."""
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))


def _kv(cache, length, rows=None):
    """Every attention cache leaf, (layers, rows, :length, kv, dh)."""
    out = []
    for seg in cache["segments"]:
        for key in sorted(seg):
            leaf = seg[key] if rows is None else seg[key][:, rows]
            out.append(leaf[:, :, :length].numpy())
    return out


def _slot_kv(eng, slot, length):
    """Slot ``slot``'s K/V leaves (layers, 1, length, kv, dh), read through
    its block table on a paged engine."""
    if eng.manager is None:
        return _kv(eng.cache, length, rows=[slot])
    pages = torch.as_tensor(eng.manager.tables[slot].astype(np.int64))
    out = []
    for seg in eng.cache["segments"]:
        for key in sorted(seg):
            leaf = seg[key][:, pages]                # (layers, pages, bs, ..)
            leaf = leaf.reshape((leaf.shape[0], -1) + tuple(leaf.shape[3:]))
            out.append(leaf[:, None, :length].numpy())
    return out


def _prefill_kv(pcfg, port, stream):
    ref = _port_engine(pcfg, port, 1)
    ref.prefill(torch.as_tensor(stream[None]))
    return _kv(ref.cache, len(stream))


# ===========================================================================
# the diffusion KV-commit rule
# ===========================================================================

def _solo_diffusion(setup, cls=DiffusionBlockDecoder, **kw):
    cfg, pcfg, params, port, prompts = setup[:5]
    eng = _port_engine(pcfg, port, 1)
    toks, stats = cls(eng, block_size=5, refine_steps=2, **kw).generate(
        prompts[2][None], TOKENS)
    return eng, np.concatenate([prompts[2], toks[:-1]]), toks, stats


def test_diffusion_committed_kv_matches_prefill(setup):
    """After a solo diffusion generation the engine's committed K/V equal
    a prefill of the resolved stream, and the stream is the reference's."""
    cfg, pcfg, params, port, prompts = setup[:5]
    eng, stream, toks, stats = _solo_diffusion(setup)
    assert eng.cache_len == len(stream)
    for got, want in zip(_kv(eng.cache, len(stream)),
                         _prefill_kv(pcfg, port, stream)):
        np.testing.assert_allclose(got, want, **KV_TOL)
    ref = _ref_engine(cfg, params, 1)
    want, want_stats = RefDiffusion(ref, block_size=5, refine_steps=2
                                    ).generate(jnp.asarray(prompts[2])[None],
                                               TOKENS)
    np.testing.assert_array_equal(toks, np.asarray(want))
    assert stats == want_stats


class _PoisonedCommit(DiffusionBlockDecoder):
    """The rule broken: no commit forward.  The cache keeps the K/V the
    last refinement forward wrote in place, where positions resolved in
    (or after) that iteration still had mask-token inputs."""

    def resolve(self, pending, drafts):
        n = len(drafts)
        block = np.asarray(drafts, np.int64).copy()
        resolved = np.zeros((n,), bool)
        per_iter = max(1, int(np.ceil(n / self.refine_steps)))
        new_cache = None
        for _ in range(self.refine_steps):
            if resolved.all():
                break
            logits, new_cache, _ = self.forward_block(
                np.concatenate([[pending], block]))
            conf, preds = (t.numpy() for t in confidence(logits[0]))
            refine_block(block, resolved, conf, preds, per_iter)
        self.engine.commit(new_cache, n)
        return list(block[:-1]), int(block[-1])


def test_diffusion_kv_regression_has_teeth(setup):
    """Negative control: with in-place writes, skipping the commit forward
    leaves mask-token K/V at committed positions, and the comparison above
    fails — so it would catch the fault."""
    _, pcfg, _, port = setup[:4]
    eng, stream, _, _ = _solo_diffusion(setup, _PoisonedCommit)
    assert any(not np.allclose(got, want, **KV_TOL)
               for got, want in zip(_kv(eng.cache, len(stream)),
                                    _prefill_kv(pcfg, port, stream)))


@pytest.mark.parametrize("bs", [0, 16], ids=["dense", "paged"])
def test_serving_diffusion_committed_kv_matches_prefill(dense_setup, bs):
    """The same rule in the scheduler: after every step, each active
    slot's committed K/V equal a prefill of its context (rows that
    resolved early rode along and were rewritten by the commit forward)."""
    _, pcfg, _, port, prompts = dense_setup[:5]
    eng = _port_engine(pcfg, port, 3, block_size=bs)
    loop = ServingLoop(eng, mode="diffusion", block_size=4, refine_steps=3)
    for p in prompts:
        loop.submit(p, TOKENS)
    checked = 0
    while True:
        loop.admit()
        if not loop.step():
            break
        for s, req in loop.active.items():
            ctx = req.context
            assert eng.slot_lens_host[s] == len(ctx)
            for got, want in zip(_slot_kv(eng, s, len(ctx)),
                                 _prefill_kv(pcfg, port, ctx)):
                np.testing.assert_allclose(got, want, **KV_TOL)
            checked += 1
    assert checked >= 3


# ===========================================================================
# batched modes against the solo drivers and the reference
# ===========================================================================

@pytest.mark.parametrize("bs", [0, 16], ids=["dense", "paged"])
def test_serving_diffusion_matches_solo(dense_setup, f32_scratch, bs):
    """ServingLoop(mode='diffusion') over a queue deeper than its slots:
    every stream equals the solo DiffusionBlockDecoder at the same block
    size and the reference loop's, forward for forward."""
    cfg, pcfg, params, port, prompts = dense_setup[:5]
    solo = [DiffusionBlockDecoder(_port_engine(pcfg, port, 1), block_size=4,
                                  refine_steps=2).generate(p[None], TOKENS)[0]
            for p in prompts]
    loop = ServingLoop(_port_engine(pcfg, port, 3, block_size=bs),
                       mode="diffusion", block_size=4, refine_steps=2)
    ref = RefLoop(_ref_engine(cfg, params, 3, block_size=bs),
                  mode="diffusion", block_size=4, refine_steps=2)
    for p in prompts:
        loop.submit(p, TOKENS)
        ref.submit(p, TOKENS)
    out, want = loop.run(), ref.run()
    assert len(out) == len(prompts)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out[i], solo[i], err_msg=str(i))
        np.testing.assert_array_equal(out[i], want[i], err_msg=str(i))
    stats, want_stats = loop.stats(), ref.stats()
    for key in ("forwards", "positions", "tokens_per_forward",
                "max_positions_per_forward"):
        assert stats[key] == want_stats[key], key
    assert stats["tokens_per_forward"] > 1.0


@pytest.mark.parametrize("bs", [0, 16], ids=["dense", "paged"])
def test_serving_mtp_matches_solo(dense_setup, f32_scratch, bs):
    """ServingLoop(mode='mtp') is lossless: every stream equals solo
    greedy decoding, the solo MTPDecoder equals it too, and the loop's
    acceptance (tokens per forward) is the reference's on the same
    bank."""
    cfg, pcfg, params, port, prompts, heads, pheads = dense_setup
    greedy = [_port_engine(pcfg, port, 1).greedy_generate(
        torch.as_tensor(p[None]), TOKENS)[0].numpy() for p in prompts]
    solo, _ = MTPDecoder(_port_engine(pcfg, port, 1), pheads).generate(
        prompts[0][None], TOKENS)
    np.testing.assert_array_equal(solo, greedy[0])
    loop = ServingLoop(_port_engine(pcfg, port, 3, block_size=bs),
                       mode="mtp", mtp_heads=pheads, max_width=5)
    ref = RefLoop(_ref_engine(cfg, params, 3, block_size=bs), mode="mtp",
                  mtp_heads=heads, max_width=5)
    for p in prompts:
        loop.submit(p, TOKENS)
        ref.submit(p, TOKENS)
    out, want = loop.run(), ref.run()
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out[i], greedy[i], err_msg=str(i))
        np.testing.assert_array_equal(out[i], want[i], err_msg=str(i))
    stats, want_stats = loop.stats(), ref.stats()
    for key in ("forwards", "positions", "tokens_per_forward"):
        assert stats[key] == want_stats[key], key


@pytest.fixture(scope="module")
def moe_golden(moe_setup):
    """The reference's MoE golden streams, its Pallas kernels interpreted
    (use_kernel=True): solo diffusion and greedy per prompt, then the
    diffusion and mtp loops."""
    cfg, _, params, _, prompts, heads, _ = moe_setup
    t = 6
    solo_diff, greedy = [], []
    for p in prompts:
        solo_diff.append(np.asarray(RefDiffusion(
            _ref_engine(cfg, params, 1, use_kernel=True), block_size=3,
            refine_steps=2).generate(jnp.asarray(p)[None], t)[0]))
        greedy.append(np.asarray(_ref_engine(
            cfg, params, 1, use_kernel=True).greedy_generate(
            jnp.asarray(p)[None], t)[0]))
    loops = {}
    for mode, kw in (("diffusion", dict(block_size=3, refine_steps=2)),
                     ("mtp", dict(mtp_heads=heads, max_width=4))):
        loop = RefLoop(_ref_engine(cfg, params, 3, use_kernel=True),
                       mode=mode, **kw)
        for p in prompts:
            loop.submit(p, t)
        loops[mode] = (loop.run(), loop.stats())
    return t, solo_diff, greedy, loops


def test_serving_modes_moe_kernel_golden(moe_setup, moe_golden):
    """llada through the kernel flag (the decode-attention and grouped-FFN
    plain versions in every forward): batched diffusion equals the solo
    driver and mtp equals greedy, each stream the reference's."""
    _, pcfg, _, port, prompts, _, pheads = moe_setup
    t, solo_diff, greedy, loops = moe_golden
    for i, p in enumerate(prompts):
        got = DiffusionBlockDecoder(
            _port_engine(pcfg, port, 1, use_kernel=True), block_size=3,
            refine_steps=2).generate(p[None], t)[0]
        np.testing.assert_array_equal(got, solo_diff[i])
        got = _port_engine(pcfg, port, 1, use_kernel=True).greedy_generate(
            torch.as_tensor(p[None]), t)[0].numpy()
        np.testing.assert_array_equal(got, greedy[i])
    for mode, kw, want in (
            ("diffusion", dict(block_size=3, refine_steps=2), solo_diff),
            ("mtp", dict(mtp_heads=pheads, max_width=4), greedy)):
        loop = ServingLoop(_port_engine(pcfg, port, 3, use_kernel=True),
                           mode=mode, **kw)
        for p in prompts:
            loop.submit(p, t)
        out = loop.run()
        ref_out, ref_stats = loops[mode]
        for i in range(len(prompts)):
            np.testing.assert_array_equal(out[i], want[i], err_msg=mode)
            np.testing.assert_array_equal(out[i], ref_out[i], err_msg=mode)
        assert loop.stats()["forwards"] == ref_stats["forwards"]


# ===========================================================================
# single-request drivers
# ===========================================================================

@pytest.mark.parametrize("algo", ["speculative", "mtp", "diffusion",
                                  "diffusion_budget"])
def test_single_request_driver_matches_reference(setup, algo):
    """Each single-request driver: the same tokens and the same forwards,
    positions and tokens per forward as the reference's on every
    prompt."""
    cfg, pcfg, params, port, prompts, heads, pheads = setup
    for p in prompts:
        ref, eng = _ref_engine(cfg, params, 1), _port_engine(pcfg, port, 1)
        if algo == "speculative":
            want = RefSpeculative(ref).generate(jnp.asarray(p)[None], TOKENS)
            got = SpeculativeDecoder(eng).generate(p[None], TOKENS)
        elif algo == "mtp":
            want = RefMTP(ref, heads).generate(jnp.asarray(p)[None], TOKENS)
            got = MTPDecoder(eng, pheads).generate(p[None], TOKENS)
        else:
            kw = (dict(block_size=4, refine_steps=3) if algo == "diffusion"
                  else {})
            want = RefDiffusion(ref, **kw).generate(jnp.asarray(p)[None],
                                                    TOKENS)
            got = DiffusionBlockDecoder(eng, **kw).generate(p[None], TOKENS)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[1] == want[1]
        assert eng.cache_len == ref.cache_len


def test_speculative_draft_engine_matches_reference(dense_setup):
    """SpeculativeDecoder with a draft engine (the same model, so every
    draft is accepted): the resync of the draft cache by moving its length
    back, and the catch-up forward, as the reference."""
    cfg, pcfg, params, port, prompts = dense_setup[:5]
    want = RefSpeculative(_ref_engine(cfg, params, 1),
                          draft_engine=_ref_engine(cfg, params, 1),
                          gamma=3).generate(jnp.asarray(prompts[1])[None],
                                            TOKENS)
    got = SpeculativeDecoder(_port_engine(pcfg, port, 1),
                             draft_engine=_port_engine(pcfg, port, 1),
                             gamma=3).generate(prompts[1][None], TOKENS)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]
    assert got[1]["tokens_per_forward"] > 1.0


# ===========================================================================
# components
# ===========================================================================

@pytest.mark.parametrize("n,per_iter", [(1, 1), (5, 2), (16, 4), (17, 17)])
def test_refine_block_picks_reference_positions(n, per_iter):
    """On the same float32 logits the port's device reduction plus host
    selection freezes the same positions with the same tokens as the
    reference's host softmax, iteration after iteration."""
    rng = np.random.default_rng(n)
    want_b, got_b = np.full(n, 255), np.full(n, 255)
    want_r, got_r = np.zeros(n, bool), np.zeros(n, bool)
    while not want_r.all():
        lg = (rng.standard_normal((n + 1, 256)) * 3).astype(np.float32)
        ref_refine(want_b, want_r, lg, per_iter)
        conf, preds = (t.numpy() for t in confidence(torch.as_tensor(lg)))
        refine_block(got_b, got_r, conf, preds, per_iter)
        np.testing.assert_array_equal(got_r, want_r)
        np.testing.assert_array_equal(got_b, want_b)


def test_confidence_is_the_max_probability():
    lg = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, 5, 64)).astype(np.float32))
    conf, preds = confidence(lg)
    probs = torch.softmax(lg, -1)
    torch.testing.assert_close(conf, probs.max(-1).values)
    torch.testing.assert_close(preds, lg.argmax(-1))


def test_mtp_propose_matches_reference(dense_setup):
    cfg, _, _, _, _, heads, pheads = dense_setup
    hid = np.random.default_rng(1).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_propose(heads, jnp.asarray(hid)))
    got = mtp_propose(pheads, torch.as_tensor(hid))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # a bf16 bank proposes from its exact f32 values
    bf = {"heads": pheads["heads"].bfloat16()}
    np.testing.assert_array_equal(
        mtp_propose(bf, torch.as_tensor(hid)).numpy(),
        mtp_propose({"heads": bf["heads"].float()},
                    torch.as_tensor(hid)).numpy())


def test_peek_step_and_commit_match_reference(dense_setup):
    """prefill keeps last_hidden; peek_step's logits and hidden states are
    the reference's and it moves no length; commit advances only the
    length, and a peek after a partial commit sees the committed K/V."""
    cfg, pcfg, params, port, prompts = dense_setup[:5]
    ref, eng = _ref_engine(cfg, params, 1), _port_engine(pcfg, port, 1)
    rl = ref.prefill(jnp.asarray(prompts[3])[None])
    pl = eng.prefill(torch.as_tensor(prompts[3][None]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **LOGIT_TOL)
    np.testing.assert_allclose(eng.last_hidden.numpy(),
                               np.asarray(ref.last_hidden), **LOGIT_TOL)
    rng = np.random.default_rng(4)
    for n, adv in ((4, 2), (3, 0), (2, 2)):
        toks = rng.integers(0, cfg.vocab_size, (1, n))
        rl, rc, rh = ref.peek_step(jnp.asarray(toks, jnp.int32))
        pl, pc, ph = eng.peek_step(torch.as_tensor(toks))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **LOGIT_TOL)
        np.testing.assert_allclose(ph.numpy(), np.asarray(rh), **LOGIT_TOL)
        assert eng.cache_len == ref.cache_len
        ref.commit(rc, adv)
        eng.commit(pc, adv)
        assert eng.cache_len == ref.cache_len
    # prefill_slot on a slotted engine: the last prompt position's logits
    slotted = _port_engine(pcfg, port, 2)
    got = slotted.prefill_slot(1, prompts[3])
    np.testing.assert_allclose(got.numpy(),
                               eng.prefill(torch.as_tensor(
                                   prompts[3][None]))[0].numpy(),
                               **LOGIT_TOL)
    assert list(slotted.slot_lens_host) == [0, len(prompts[3])]


def test_llada_init_scales_match_reference():
    """The port's init at llada's E = 256 top-8, d_ff 512: router 0.02,
    expert leaves 1/sqrt(E) = 1/16, as the reference's ``_init`` (at a
    narrow d and one layer, so that the check stays small)."""
    def small(cfg):
        return dataclasses.replace(
            cfg, n_layers=1, d_model=32, vocab_size=64,
            attention=dataclasses.replace(cfg.attention, n_heads=2,
                                          n_kv_heads=1, head_dim=16))
    pcfg = port_config("llada_mini_like")
    assert (pcfg.ffn.n_experts, pcfg.ffn.top_k, pcfg.ffn.d_ff) == \
        (256, 8, 512)
    ffn = port_init_model(small(pcfg), torch.Generator().manual_seed(0),
                          "cpu", torch.float32)["segments"][0]["ffn"]
    ref = init_model(jax.random.PRNGKey(0), small(get_config(
        "llada_mini_like")), dtype=jnp.float32)["segments"][0]["ffn"]
    for key in ("router", "w_up", "w_gate", "w_down"):
        assert tuple(ffn[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(float(ffn[key].std()),
                                   float(np.asarray(ref[key]).std()),
                                   rtol=0.05)
    assert abs(float(ffn["w_up"].std()) - 1 / 16) < 1e-3


# ===========================================================================
# the serve CLI
# ===========================================================================

@pytest.mark.parametrize("argv", [
    ["--algorithm", "diffusion", "--arch", "wedlm8b_like"],
    ["--algorithm", "mtp", "--arch", "llada_mini_like"],
    ["--algorithm", "speculative"],
    ["--serve-mode", "diffusion", "--arch", "llada_mini_like",
     "--kv-block-size", "16", "--block-size", "4"],
    ["--serve-mode", "mtp", "--arch", "wedlm8b_like"],
], ids=["solo-diffusion", "solo-mtp", "solo-speculative", "paged-diffusion",
        "mtp"])
def test_serve_cli(argv, capsys):
    serve(build_parser().parse_args(
        ["--device", "cpu", "--tiny", "--requests", "3", "--slots", "2",
         "--tokens", "8"] + argv))
    out = capsys.readouterr().out
    assert ("generated 8 tokens" in out) or ("served 3 requests / 24 tokens"
                                             in out)


def test_serve_cli_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve(build_parser().parse_args(["--tiny", "--algorithm", "mtp"]))
