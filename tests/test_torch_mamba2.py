"""The port's Mamba2 block and hybrid layer (zamba2) against the
reference's: ``mamba2_block`` (its three causal convs, the per-position
recurrence, the gated norm) in full and decode modes with one and two
B/C groups; the ``init_mamba2`` layout; reduced ``zamba2_1p2b`` (Mamba2
layers and hybrid layers sharing ONE attention + MLP block) through
``forward`` in train, prefill and multi-position decode at a scalar and
at per-row lengths; the engine and greedy ``ServingLoop``; and what the
port refuses for a recurrent model.

Everything is float32 with numpy-made inputs.  Tolerances: the block
1e-5 (both sides take the same products in the same order; XLA's and
torch's exp and the ds-term sums may differ by an ulp a step, observed
~1e-6); the forward 1e-5 relative to the largest logit, as the
reference's own prefill/decode-vs-full check (observed ~1e-6); greedy
streams identical.

The reference leaks a reused slot's Mamba2 state into the next prompt's
prefill, as it does for Mamba1 (``test_torch_mamba.py``): its serving
streams are compared with the port's only where no slot is reused, and
otherwise with the reference's fresh-engine ``greedy_generate``."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.arch import SSMSpec as RefSSMSpec  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import arch as port_arch  # noqa: E402
from repro_torch.core.arch import LAYER_HYBRID  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models import forward, init_cache  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (DecodeEngine, PagedKVConfig,  # noqa: E402
                                 ServingLoop, init_mtp_heads)
from repro_torch.serving.spans import untimed  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "zamba2_1p2b"
MAX_LEN, TOKENS = 64, 8
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _max_rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.detach().numpy() - want)) / np.max(np.abs(want))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _spec(n_groups):
    """d_model 32 -> d_inner 64, two heads of 32 over ds 8; with two
    groups each group's B and C serve one head."""
    return RefSSMSpec(kind="mamba2", d_state=8, d_conv=4, expand=2,
                      head_dim=32, n_groups=n_groups)


@pytest.fixture(scope="module", params=[1, 2], ids=["groups1", "groups2"])
def block(request):
    """One reference Mamba2 layer (d_model 32) with nonzero A_logh, D,
    dt_bias, conv biases and norm scale (their inits are constants, which
    would hide a per-head or per-channel mix-up), its port copy, an input
    and a nonzero state."""
    spec = _spec(request.param)
    params = ref_mamba.init_mamba2(jax.random.PRNGKey(5), 32, spec,
                                   dtype=jnp.float32)
    rng = np.random.default_rng(6)
    for key in ("A_logh", "D", "dt_bias", "conv_b", "convB_b", "convC_b"):
        params[key] = jnp.asarray(
            0.5 * rng.standard_normal(params[key].shape), jnp.float32)
    params["norm"]["scale"] = jnp.asarray(
        1 + 0.1 * rng.standard_normal(64), jnp.float32)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    gs = request.param * 8
    state = {"conv": rng.standard_normal((2, 3, 64)).astype(np.float32),
             "convB": rng.standard_normal((2, 3, gs)).astype(np.float32),
             "convC": rng.standard_normal((2, 3, gs)).astype(np.float32),
             "ssm": rng.standard_normal((2, 2, 32, 8)).astype(np.float32)}
    port = params_from_jax(jax.tree.map(np.asarray, params))
    port_spec = port_arch.SSMSpec(**dataclasses.asdict(spec))
    return spec, port_spec, params, port, x, state


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_mamba2_block_matches_reference(block, mode):
    """Full mode (no state) and decode mode (6 positions advancing a
    nonzero cached state): the output and the four new state leaves
    (the x, B and C conv histories and the ssm state); the state given
    is read, not written."""
    spec, port_spec, params, port, x, state = block
    st = None if mode == "full" else jax.tree.map(jnp.asarray, state)
    want, want_state = ref_mamba.mamba2_block(params, spec, jnp.asarray(x),
                                              st)
    pst = None if mode == "full" else {k: _t(v) for k, v in state.items()}
    got, got_state = mamba.mamba2_block(port, port_spec, _t(x), pst)
    _close(got, want)
    if mode == "full":
        assert got_state is None and want_state is None
        return
    assert got_state.keys() == want_state.keys()
    for key in want_state:
        _close(got_state[key], want_state[key])
        assert torch.equal(pst[key], _t(state[key]))      # read, not written


def test_mamba2_decode_in_steps_equals_one_block(block):
    """Six positions as one decode block, and as blocks of 1, 2 and 3
    threading the state: the same output and final state (the loop over
    positions is the recurrence, not a per-block approximation)."""
    _, port_spec, _, port, x, state = block
    st = {k: _t(v) for k, v in state.items()}
    whole, whole_state = mamba.mamba2_block(port, port_spec, _t(x), st)
    outs = []
    for lo, hi in ((0, 1), (1, 3), (3, 6)):
        out, st = mamba.mamba2_block(port, port_spec, _t(x[:, lo:hi]), st)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, **TOL)
    for key in whole_state:
        torch.testing.assert_close(st[key], whole_state[key], **TOL)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_init_mamba2_has_reference_layout(n_groups):
    """The port's ``init_mamba2`` (with a leading layer axis) and
    ``init_mamba2_state``: the reference's leaves, shapes and dtypes (the
    values differ: another generator), the f32 per-head A_logh, D and
    dt_bias, and the conv histories in the activation type."""
    spec = _spec(n_groups)
    port_spec = port_arch.SSMSpec(**dataclasses.asdict(spec))
    ref = ref_mamba.init_mamba2(jax.random.PRNGKey(0), 32, spec)
    port = mamba.init_mamba2(torch.Generator().manual_seed(0), 32, port_spec,
                             lead=(3,))
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == (3,) + r.shape
        assert p.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)
    assert torch.equal(port["D"], torch.ones(3, 2))
    ref_state = ref_mamba.init_mamba2_state(2, 32, spec)
    state = mamba.init_mamba2_state(2, 32, port_spec, torch.float32, "cpu",
                                    (3,))
    assert state.keys() == ref_state.keys()
    for key, r in ref_state.items():
        assert tuple(state[key].shape) == (3,) + r.shape
    assert state["conv"].dtype == state["convB"].dtype == torch.float32
    assert state["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(ARCH, reduced=True), params, port


def test_reduced_zamba2_has_hybrid_segments(model):
    """Reduced zamba2: Mamba2 and hybrid layers alternate, so the forward
    below runs both segment kinds and the shared block twice."""
    _, pcfg, _, port = model
    kinds = [kind for kind, _ in transformer.make_segments(pcfg)]
    assert kinds == ["ssm", "hybrid", "ssm", "hybrid"]
    assert pcfg.count_layers(LAYER_HYBRID) == 2
    assert set(port["shared_attn"]) == {"attn", "ln2", "ffn"}


def test_train_logits_match_reference(model):
    cfg, pcfg, params, port = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    rl, _, _, rh = ref_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    for use_kernel in (False, True):
        pl, _, pa, ph = forward(port, pcfg, {"tokens": _t(toks)},
                                use_kernel=use_kernel)
        assert _max_rel(pl, rl) < 1e-5
        assert _max_rel(ph, rh) < 1e-5
        assert float(pa) == 0.0


def _cache_leaves(cache):
    return dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(cache)[0]],
        jax.tree.leaves(cache)))


@pytest.mark.parametrize("lens", ["scalar", "per_row"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_reference(model, use_kernel, lens):
    """Prefill of 3 rows into a fresh cache, then a 4-position decode
    forward (every row at 10, or at its own length 10 / 7 / 9): logits,
    hidden states and every cache leaf (Mamba2 states, the hybrid
    layers' K/V) against the reference; the states given to decode are
    left as they were."""
    cfg, pcfg, params, port = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 10))
    dec = rng.integers(0, cfg.vocab_size, (3, 4))
    rl, rc, _, rh = ref_forward(
        params, cfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
        cache=ref_init_cache(cfg, 3, 32, dtype=jnp.float32))
    pl, pc, _, ph = forward(port, pcfg, {"tokens": _t(toks)}, mode="prefill",
                            cache=init_cache(pcfg, 3, 32, torch.float32,
                                             "cpu"),
                            use_kernel=use_kernel)
    assert _max_rel(pl, rl) < 1e-5 and _max_rel(ph, rh) < 1e-5
    want, got = _cache_leaves(rc), _cache_leaves(pc)
    assert want.keys() == got.keys()
    for key in want:
        _close(got[key], want[key])
    cl = [10, 7, 9] if lens == "per_row" else 10
    rl2, rc2, _, rh2 = ref_forward(params, cfg, {"tokens": jnp.asarray(dec)},
                                   mode="decode", cache=rc,
                                   cache_len=jnp.asarray(cl, jnp.int32))
    states = [transformer.segment_states(kind, seg) for (kind, _), seg in
              zip(transformer.make_segments(pcfg), pc["segments"])]
    before = jax.tree.map(torch.clone, states)
    pl2, pc2, _, ph2 = forward(port, pcfg, {"tokens": _t(dec)},
                               mode="decode", cache=pc,
                               cache_len=_t(np.array(cl, np.int32)),
                               use_kernel=use_kernel)
    assert _max_rel(pl2, rl2) < 1e-5 and _max_rel(ph2, rh2) < 1e-5
    want, got = _cache_leaves(rc2), _cache_leaves(pc2)
    for key in want:
        _close(got[key], want[key])
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(states),
                                                 jax.tree.leaves(before)))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_then_decode_equals_full_forward(model, use_kernel):
    """Prefill 12 + decode 4 == the full forward (the port's counterpart
    of the reference's consistency check)."""
    cfg, pcfg, _, port = model
    toks = _t(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    full, _, _, _ = forward(port, pcfg, {"tokens": toks},
                            use_kernel=use_kernel)
    _, cache, _, _ = forward(port, pcfg, {"tokens": toks[:, :12]},
                             mode="prefill",
                             cache=init_cache(pcfg, 2, 16, torch.float32,
                                              "cpu"),
                             use_kernel=use_kernel)
    dec, _, _, _ = forward(port, pcfg, {"tokens": toks[:, 12:]},
                           mode="decode", cache=cache, cache_len=12,
                           use_kernel=use_kernel)
    assert _max_rel(dec, full[:, 12:]) < 1e-5


def test_prefill_ignores_a_stale_state(model):
    """Prefill starts every Mamba2 state from zero, the hybrid layers'
    included, whatever the cache holds."""
    cfg, pcfg, _, port = model
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7)))
    fresh = init_cache(pcfg, 2, 16, torch.float32, "cpu")
    stale = jax.tree.map(lambda v: torch.full_like(v, 3.0), fresh)
    a, ca, _, _ = forward(port, pcfg, {"tokens": toks}, mode="prefill",
                          cache=fresh)
    b, cb, _, _ = forward(port, pcfg, {"tokens": toks}, mode="prefill",
                          cache=stale)
    assert torch.equal(a, b)
    for kind, sa, sb in zip([k for k, _ in transformer.make_segments(pcfg)],
                            ca["segments"], cb["segments"]):
        for key, v in transformer.segment_states(kind, sa).items():
            assert torch.equal(v, transformer.segment_states(kind, sb)[key])


def test_init_cache_nests_the_hybrid_state(model):
    """A hybrid segment's cache is {"ssm_state": the Mamba2 state, "attn":
    K/V of max_len} per layer, stacked, as the reference's; the ring
    buffer does not apply to it."""
    cfg, pcfg, _, _ = model
    ref = ref_init_cache(cfg, 3, 48, dtype=jnp.float32)
    port = init_cache(pcfg, 3, 48, torch.float32, "cpu", swa_ring=True)
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == r.shape
    hybrid = port["segments"][1]
    assert hybrid["attn"]["k"].shape == (1, 3, 48, 4, 16)
    assert hybrid["ssm_state"]["ssm"].shape == (1, 3, 4, 32, 16)


# ---------------------------------------------------------------------------
# engine and serving
# ---------------------------------------------------------------------------

def _port_engine(pcfg, port, batch, use_kernel=False):
    return DecodeEngine(pcfg, port, batch=batch, max_len=MAX_LEN,
                        hardware=HW, use_kernel=use_kernel, device="cpu")


def _ref_engine(cfg, params, batch):
    return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                     cache=ref_init_cache(cfg, batch, MAX_LEN,
                                          dtype=jnp.float32))


def _prompts(vocab, n):
    """Prompts of lengths 5, 9, 5, 12, 9, 7, ...: equal lengths prefill
    together."""
    rng = np.random.default_rng(7)
    lens = [5, 9, 5, 12, 9, 7]
    return [rng.integers(0, vocab, size=lens[i % len(lens)])
            for i in range(n)]


def _serve(loop, prompts):
    for p in prompts:
        loop.submit(p, TOKENS)
    return loop.run()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_streams_match_reference_without_slot_reuse(model, use_kernel):
    """4 requests on 4 slots, dense greedy: streams, prefill log
    (exact-length groups) and forwards identical to the reference's
    ServingLoop."""
    cfg, pcfg, params, port = model
    prompts = _prompts(cfg.vocab_size, 4)
    ref = _ref_engine(cfg, params, 4)
    want = _serve(RefLoop(ref), prompts)
    eng = _port_engine(pcfg, port, 4, use_kernel)
    loop = ServingLoop(eng)
    got = _serve(loop, prompts)
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    assert untimed(eng.prefill_log) == ref.prefill_log
    assert [e["bucket"] for e in eng.prefill_log] == [5, 9, 12]
    assert loop.stats()["forwards"] == TOKENS - 1


def test_reused_slots_equal_solo_reference_streams(model):
    """6 requests on 2 slots (every slot reused): each stream equals the
    reference's greedy_generate of that request in a fresh engine, and
    so does the port's own batch-1 driver."""
    cfg, pcfg, params, port = model
    prompts = _prompts(cfg.vocab_size, 6)
    got = _serve(ServingLoop(_port_engine(pcfg, port, 2)), prompts)
    solo = _port_engine(pcfg, port, 1)
    for rid, prompt in enumerate(prompts):
        want = np.asarray(_ref_engine(cfg, params, 1).greedy_generate(
            jnp.asarray(prompt[None], jnp.int32), TOKENS))[0]
        np.testing.assert_array_equal(got[rid], want, err_msg=str(rid))
        again = solo.greedy_generate(_t(prompt[None]), TOKENS)
        np.testing.assert_array_equal(again[0].numpy(), want)


def test_commit_adopts_only_the_hybrid_state(model):
    """commit_slots copies the new Mamba2 states of the rows that
    advanced (the hybrid segments' ``ssm_state`` included) and keeps the
    others'; the hybrid K/V were written in place by the forward and are
    the cache's own tensors."""
    cfg, pcfg, _, port = model
    a, b = _prompts(cfg.vocab_size, 2)
    eng = _port_engine(pcfg, port, 2)
    eng.prefill_slots({0: a, 1: b})
    before = jax.tree.map(torch.clone, eng.cache)
    _, cache, _ = eng.decode_slots(_t([[3], [4]]))
    hybrid, new = eng.cache["segments"][1], cache["segments"][1]
    assert new["attn"]["k"] is hybrid["attn"]["k"]
    # the decode wrote K/V at each row's length, in place
    assert not torch.equal(hybrid["attn"]["k"],
                           before["segments"][1]["attn"]["k"])
    eng.commit_slots(cache, [1, 0])
    for si in (0, 1):
        kind = transformer.make_segments(pcfg)[si][0]
        old = transformer.segment_states(kind, before["segments"][si])
        got = transformer.segment_states(kind, eng.cache["segments"][si])
        moved = transformer.segment_states(kind, cache["segments"][si])
        for key in ("conv", "convB", "convC", "ssm"):
            assert torch.equal(got[key][:, 1], old[key][:, 1])
            assert torch.equal(got[key][:, 0], moved[key][:, 0])
            assert not torch.equal(got[key][:, 0], old[key][:, 0])
    np.testing.assert_array_equal(eng.slot_lens_host, [len(a) + 1, len(b)])


def test_reused_slot_prefill_starts_from_zero(model):
    """A slot that served prompt A then prefills prompt B gives B's
    logits bitwise as a fresh engine does."""
    cfg, pcfg, _, port = model
    a, b = _prompts(cfg.vocab_size, 2)
    eng = _port_engine(pcfg, port, 2)
    eng.prefill_slots({0: a})
    for _ in range(3):
        _, cache, _ = eng.decode_slots(torch.zeros((2, 1), dtype=torch.long))
        eng.commit_slots(cache, [1, 0])
    eng.release_slot(0)
    got = eng.prefill_slots({0: b})[0][0]
    want = _port_engine(pcfg, port, 2).prefill_slots({0: b})[0][0]
    assert torch.equal(got, want)


def test_reference_reused_slot_prefill_leaks_mamba2_state(model):
    """The reference prefills a reused slot from its previous request's
    Mamba2 state (``mamba2_block`` takes the slot's conv histories and
    ssm state from the cache), as it does for Mamba1: prompt B after
    prompt A in slot 0 gives other last-position logits than B in a fresh
    engine.  The port's equal the fresh reference's."""
    cfg, pcfg, params, port = model
    a, b = _prompts(cfg.vocab_size, 2)
    ref = _ref_engine(cfg, params, 2)
    ref.prefill_slots({0: jnp.asarray(a)})
    ref.release_slot(0)
    leaked = np.asarray(ref.prefill_slots({0: jnp.asarray(b)})[0][0])
    fresh = np.asarray(_ref_engine(cfg, params, 2).prefill_slots(
        {0: jnp.asarray(b)})[0][0])
    assert np.abs(leaked - fresh).max() > 1e-3
    eng = _port_engine(pcfg, port, 2)
    eng.prefill_slots({0: a})
    eng.release_slot(0)
    got = eng.prefill_slots({0: b})[0][0].numpy()
    np.testing.assert_allclose(got, fresh, **TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_paged_engine_refuses_the_hybrid_model(model):
    _, pcfg, _, port = model
    with pytest.raises(ValueError, match="attention-only"):
        DecodeEngine(pcfg, port, batch=2, max_len=MAX_LEN, device="cpu",
                     paged=PagedKVConfig(block_size=16))


@pytest.mark.parametrize("mode", ["speculative", "mtp", "diffusion"])
def test_parallel_modes_refuse_the_hybrid_model(model, mode):
    _, pcfg, _, port = model
    kw = ({"mtp_heads": init_mtp_heads(torch.Generator().manual_seed(0),
                                       pcfg.d_model, pcfg.vocab_size, 2)}
          if mode == "mtp" else {})
    with pytest.raises(ValueError, match="recurrent SSM state"):
        ServingLoop(_port_engine(pcfg, port, 2), mode=mode, **kw)


def test_partial_commit_refused(model):
    _, pcfg, _, port = model
    eng = _port_engine(pcfg, port, 1)
    eng.prefill(_t([[1, 2, 3]]))
    with pytest.raises(ValueError, match="recurrent state"):
        eng.decode_step(_t([[4, 5, 6]]), advance=2)
