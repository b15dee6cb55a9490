"""The port's Mamba1 path against the reference's: the selective scan
(plain version, and the kernel wrapper's CPU path with its chunk padding)
against the reference oracle ``selective_scan_ref`` and the reference
``selective_scan`` (its Pallas kernel in interpret mode, as the
reference's own tests run it); ``causal_conv1d`` and ``mamba1_block`` in
full and decode modes, kernel flag both ways; reduced ``falcon_mamba_7b``
through ``forward`` (train, prefill, multi-position decode); the engine
and greedy ``ServingLoop``; and what the port refuses.

Everything is float32 with numpy-made inputs, so the point is the
algorithm.  Tolerances: the scan and the block 1e-5 (both sides take the
same products, XLA's and torch's exp and the ds-term sums may differ by
an ulp per step, observed <= 2e-6 through 33 steps); the forward 1e-5
relative to the largest logit, as the reference's own
prefill/decode-vs-full check (observed ~1e-6); greedy streams identical.

The reference serves SSM models wrongly in two places (speculative
verify adopts state advanced over rejected drafts; a reused slot's
prefill starts from the previous request's state).  The port refuses the
first and prefills from a zero state, so its streams are compared with
the reference only where neither fault can show: no slot reuse, or the
reference's ``greedy_generate`` of each request in a fresh engine."""
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
from repro.kernels.mamba_scan.ops import selective_scan as ref_scan  # noqa: E402
from repro.kernels.mamba_scan.ref import selective_scan_ref as ref_oracle  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import arch as port_arch  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.models import forward, init_cache, init_model as port_init  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop  # noqa: E402
from repro_torch.serving.spans import untimed  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's SCAN_CASES (tests/test_kernels.py): (b, s, di, ds)
SCAN_CASES = [(2, 16, 64, 16), (1, 7, 32, 8), (2, 33, 128, 16), (1, 1, 64, 16)]
ARCH = "falcon_mamba_7b"
MAX_LEN, TOKENS = 64, 8
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _scan_inputs(b, s, di, ds, seed=0):
    """x, dt (softplus of a normal, as the block makes it), B, C, A
    (negative, as -exp(A_log)) and a nonzero h0, float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di))))
    b_in = rng.standard_normal((b, s, ds))
    c_in = rng.standard_normal((b, s, ds))
    a = -np.exp(rng.standard_normal((di, ds)) * 0.5)
    h0 = rng.standard_normal((b, di, ds))
    return [v.astype(np.float32) for v in (x, dt, b_in, c_in, a, h0)]


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_matches_reference(case):
    """Plain version and the wrapper's CPU path (padded to 16) against
    the reference oracle and the Pallas kernel in interpret mode."""
    args = _scan_inputs(*case)
    yo, ho = ref_oracle(*map(jnp.asarray, args))
    yk, hk = ref_scan(*map(jnp.asarray, args), interpret=True)
    for fn in (ops.selective_scan_ref, ops.selective_scan):
        y, h = fn(*map(_t, args))
        assert y.shape == case[:3] and h.shape == (case[0], case[2], case[3])
        for want_y, want_h in ((yo, ho), (yk, hk)):
            _close(y, want_y)
            _close(h, want_h)


def test_scan_padding_is_identity():
    """dt = x = B = C = 0 steps leave the state bitwise unchanged: the
    state after 5 real positions, padded to 16, equals the unpadded loop's
    and the reference kernel's (the reference's padding case)."""
    args = _scan_inputs(1, 5, 16, 8, seed=3)
    _, h_plain = ops.selective_scan_ref(*map(_t, args))
    y_pad, h_pad = ops.selective_scan_padded(
        *(ops.pad_positions(_t(v), 16) for v in args[:4]), *map(_t, args[4:]))
    assert y_pad.shape == (1, 16, 16)
    assert torch.equal(h_pad, h_plain)
    _, hk = ref_scan(*map(jnp.asarray, args), interpret=True)
    _close(h_pad, hk)
    _, h_wrapped = ops.selective_scan(*map(_t, args))
    assert torch.equal(h_wrapped, h_plain)


def test_cpu_scan_does_not_count_launches():
    ops.selective_scan_padded.launches = 0
    ops.selective_scan(*map(_t, _scan_inputs(2, 3, 8, 4)))
    assert ops.selective_scan_padded.launches == 0


# ---------------------------------------------------------------------------
# conv and block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state
          else None)
    want, want_state = ref_mamba.causal_conv1d(
        *map(jnp.asarray, (x, w, b)), None if st is None else jnp.asarray(st))
    got, got_state = mamba.causal_conv1d(_t(x), _t(w), _t(b),
                                         None if st is None else _t(st))
    _close(got, want)
    _close(got_state, want_state)


SPEC = RefSSMSpec(kind="mamba1", d_state=8, d_conv=4, expand=2)
PORT_SPEC = port_arch.SSMSpec(**dataclasses.asdict(SPEC))


@pytest.fixture(scope="module")
def block():
    """One reference Mamba1 layer (d_model 32), its port copy, an input
    and a nonzero state; reference results memoized by (mode, kernel)."""
    params = ref_mamba.init_mamba1(jax.random.PRNGKey(5), 32, SPEC,
                                   dtype=jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    state = {"conv": rng.standard_normal((2, 3, 64)).astype(np.float32),
             "ssm": rng.standard_normal((2, 64, 8)).astype(np.float32)}
    memo = {}

    def ref(mode, use_kernel):
        if (mode, use_kernel) not in memo:
            st = (None if mode == "full"
                  else jax.tree.map(jnp.asarray, state))
            memo[mode, use_kernel] = ref_mamba.mamba1_block(
                params, SPEC, jnp.asarray(x), st, use_kernel)
        return memo[mode, use_kernel]
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return port, x, state, ref


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("mode", ["full", "decode"])
def test_mamba1_block_matches_reference(block, mode, use_kernel):
    """Full mode (no state) and decode mode (6 positions advancing a
    nonzero cached state), against the reference with the same flag."""
    port, x, state, ref = block
    want, want_state = ref(mode, use_kernel)
    st = None if mode == "full" else {k: _t(v) for k, v in state.items()}
    got, got_state = mamba.mamba1_block(port, PORT_SPEC, _t(x), st,
                                        use_kernel)
    _close(got, want)
    if mode == "full":
        assert got_state is None and want_state is None
        return
    for key in ("conv", "ssm"):
        _close(got_state[key], want_state[key])
        assert torch.equal(st[key], _t(state[key]))       # read, not written


def test_mamba2_is_not_ported():
    """Named when Mamba2 raised; it is ported now
    (``tests/test_torch_mamba2.py`` holds it against the reference): one
    block of the port's own init runs, full and decode, to finite outputs
    and a state of the reference's shapes."""
    spec = port_arch.SSMSpec(kind="mamba2", d_state=8, d_conv=4, expand=2,
                             head_dim=16, n_groups=2)
    params = mamba.init_mamba2(torch.Generator().manual_seed(0), 32, spec,
                               torch.float32)
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    out, none = mamba.mamba2_block(params, spec, x)
    assert none is None and out.shape == x.shape
    state = mamba.init_mamba2_state(2, 32, spec, torch.float32, "cpu")
    out, new = mamba.mamba2_block(params, spec, x, state)
    assert torch.isfinite(out).all()
    assert new["ssm"].shape == (2, 4, 16, 8)
    assert new["convB"].shape == new["convC"].shape == (2, 3, 16)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(ARCH, reduced=True), params, port


def _max_rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.detach().numpy() - want)) / np.max(np.abs(want))


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


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_reference(model, use_kernel):
    """Prefill of 3 rows into a fresh cache, then a 4-position decode
    forward: logits, hidden states and both states against the
    reference; the cache given to decode is left as it was."""
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
    for key in ("conv", "ssm"):
        _close(pc["segments"][0][key], rc["segments"][0][key])
    rl2, rc2, _, rh2 = ref_forward(params, cfg, {"tokens": jnp.asarray(dec)},
                                   mode="decode", cache=rc,
                                   cache_len=jnp.asarray(10, jnp.int32))
    before = jax.tree.map(torch.clone, pc)
    pl2, pc2, _, ph2 = forward(port, pcfg, {"tokens": _t(dec)},
                               mode="decode", cache=pc, cache_len=10,
                               use_kernel=use_kernel)
    assert _max_rel(pl2, rl2) < 1e-5 and _max_rel(ph2, rh2) < 1e-5
    for key in ("conv", "ssm"):
        _close(pc2["segments"][0][key], rc2["segments"][0][key])
        assert torch.equal(pc["segments"][0][key], before["segments"][0][key])


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_then_decode_equals_full_forward(model, use_kernel):
    """The port's own counterpart of the reference's consistency check
    (tests/test_models.py): prefill 12 + decode 4 == the full forward."""
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
    """Prefill starts from a zero state whatever the cache holds."""
    cfg, pcfg, _, port = model
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7)))
    fresh = init_cache(pcfg, 2, 16, torch.float32, "cpu")
    stale = jax.tree.map(lambda v: torch.full_like(v, 3.0), fresh)
    a, ca, _, _ = forward(port, pcfg, {"tokens": toks}, mode="prefill",
                          cache=fresh)
    b, cb, _, _ = forward(port, pcfg, {"tokens": toks}, mode="prefill",
                          cache=stale)
    assert torch.equal(a, b)
    for key in ("conv", "ssm"):
        assert torch.equal(ca["segments"][0][key], cb["segments"][0][key])


def test_port_init_builds_stacked_ssm_state(model):
    cfg, pcfg, _, _ = model
    params = port_init(pcfg, torch.Generator().manual_seed(0), "cpu")
    ssm = params["segments"][0]["ssm"]
    di = 2 * cfg.d_model
    assert ssm["A_log"].shape == (cfg.n_layers, di, cfg.ssm.d_state)
    assert ssm["A_log"].dtype == ssm["D"].dtype == torch.float32
    assert ssm["in_x"].dtype == torch.bfloat16
    cache = init_cache(pcfg, 3, 16, torch.bfloat16, "cpu")["segments"][0]
    assert cache["conv"].shape == (cfg.n_layers, 3, 3, di)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].shape == (cfg.n_layers, 3, di, cfg.ssm.d_state)
    assert cache["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# engine and serving
# ---------------------------------------------------------------------------

def _port_engine(pcfg, port, batch, use_kernel=False):
    return DecodeEngine(pcfg, port, batch=batch, max_len=MAX_LEN,
                        hardware=HW, use_kernel=use_kernel, device="cpu")


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
    """4 requests on 4 slots: streams, prefill log (exact-length groups)
    and forwards identical to the reference's ServingLoop."""
    cfg, pcfg, params, port = model
    prompts = _prompts(cfg.vocab_size, 4)
    ref = RefEngine(cfg, params, batch=4, max_len=MAX_LEN,
                    cache=ref_init_cache(cfg, 4, MAX_LEN, dtype=jnp.float32))
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


@pytest.fixture(scope="module")
def solo_streams(model):
    """Each of 6 requests decoded alone by the reference's greedy_generate
    in a fresh engine: the reference's leak-free path."""
    cfg, _, params, _ = model
    out = []
    for prompt in _prompts(cfg.vocab_size, 6):
        ref = RefEngine(cfg, params, batch=1, max_len=MAX_LEN,
                        cache=ref_init_cache(cfg, 1, MAX_LEN,
                                             dtype=jnp.float32))
        out.append(np.asarray(ref.greedy_generate(
            jnp.asarray(prompt[None], jnp.int32), TOKENS))[0])
    return out


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_reused_slots_equal_solo_reference_streams(model, solo_streams,
                                                   use_kernel):
    """6 requests on 2 slots (every slot reused): each stream equals the
    reference's solo greedy decode of that request, and so does the
    port's own solo driver."""
    cfg, pcfg, _, port = model
    prompts = _prompts(cfg.vocab_size, 6)
    got = _serve(ServingLoop(_port_engine(pcfg, port, 2, use_kernel)),
                 prompts)
    solo = _port_engine(pcfg, port, 1, use_kernel)
    for rid, want in enumerate(solo_streams):
        np.testing.assert_array_equal(got[rid], want, err_msg=str(rid))
        again = solo.greedy_generate(_t(prompts[rid][None]), TOKENS)
        np.testing.assert_array_equal(again[0].numpy(), want)


def test_preemption_resumes_solo_streams(model, solo_streams):
    """A request evicted mid-stream re-prefills its whole context from a
    zero state at re-admission and still ends as its solo decode."""
    cfg, pcfg, _, port = model
    prompts = _prompts(cfg.vocab_size, 3)
    loop = ServingLoop(_port_engine(pcfg, port, 2))
    for p in prompts:
        loop.submit(p, TOKENS)
    loop.admit()
    for _ in range(3):
        loop.step()
    loop.preempt(min(loop.active))
    while True:
        loop.admit()
        if not loop.step():
            break
    assert loop.preempted_total == 1 and loop.resumed_total == 1
    for rid in range(3):
        np.testing.assert_array_equal(loop.finished[rid].tokens(),
                                      solo_streams[rid])


def test_reused_slot_prefill_starts_from_zero(model):
    """A slot that served prompt A then prefills prompt B gives B's
    logits bitwise as a fresh engine does."""
    cfg, pcfg, _, port = model
    a, b = _prompts(cfg.vocab_size, 2)
    eng = _port_engine(pcfg, port, 2)
    eng.prefill_slots({0: a})
    for _ in range(3):
        logits, cache, _ = eng.decode_slots(torch.zeros((2, 1),
                                                        dtype=torch.long))
        eng.commit_slots(cache, [1, 0])
    eng.release_slot(0)
    got = eng.prefill_slots({0: b})[0][0]
    want = _port_engine(pcfg, port, 2).prefill_slots({0: b})[0][0]
    assert torch.equal(got, want)


def test_commit_keeps_the_state_of_rows_that_did_not_advance(model):
    cfg, pcfg, _, port = model
    a, b = _prompts(cfg.vocab_size, 2)
    eng = _port_engine(pcfg, port, 2)
    eng.prefill_slots({0: a, 1: b})
    before = jax.tree.map(torch.clone, eng.cache)
    _, cache, _ = eng.decode_slots(_t([[3], [4]]))
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(eng.cache), jax.tree.leaves(before)))
    eng.commit_slots(cache, [1, 0])
    for key in ("conv", "ssm"):
        new, old = eng.cache["segments"][0][key], before["segments"][0][key]
        assert torch.equal(new[:, 1], old[:, 1])
        assert torch.equal(new[:, 0], cache["segments"][0][key][:, 0])
        assert not torch.equal(new[:, 0], old[:, 0])
    np.testing.assert_array_equal(eng.slot_lens_host, [len(a) + 1, len(b)])


# ---------------------------------------------------------------------------
# the reference's two SSM serving faults, which the port does not copy
# ---------------------------------------------------------------------------

def _ref_engine(cfg, params, batch):
    return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                     cache=ref_init_cache(cfg, batch, MAX_LEN,
                                          dtype=jnp.float32))


def test_reference_speculative_ssm_serving_is_lossy(model):
    """The reference's verify forward advances the recurrent state over
    the rejected drafts too, and its commit adopts that state: its
    speculative streams part from its greedy ones (here at token 2 for
    both requests admitted first).  The port refuses the mode
    (``test_speculative_mode_refuses_an_ssm_model``)."""
    cfg, _, params, _ = model
    prompts = _prompts(cfg.vocab_size, 3)
    streams = {mode: _serve(RefLoop(_ref_engine(cfg, params, 2), mode=mode),
                            prompts)
               for mode in ("greedy", "speculative")}
    for rid in (0, 1):
        parted = np.nonzero(streams["greedy"][rid]
                            != streams["speculative"][rid])[0]
        assert parted[0] == 2, rid


def test_reference_reused_slot_prefill_leaks_state(model):
    """The reference prefills a reused slot from its previous request's
    state: prompt B after prompt A in slot 0 gives last-position logits
    6.8e-3 away from B in a fresh engine.  The port's are bitwise equal."""
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

def test_paged_engine_refuses_an_ssm_model(model):
    _, pcfg, _, port = model
    with pytest.raises(ValueError, match="attention-only"):
        DecodeEngine(pcfg, port, batch=2, max_len=MAX_LEN, device="cpu",
                     paged=PagedKVConfig(block_size=16))
    from repro_torch.models import init_paged_cache
    with pytest.raises(ValueError, match="attention-only"):
        init_paged_cache(pcfg, 9, 16, torch.float32, "cpu")


def test_speculative_mode_refuses_an_ssm_model(model):
    _, pcfg, _, port = model
    with pytest.raises(ValueError, match="recurrent SSM state"):
        ServingLoop(_port_engine(pcfg, port, 2), mode="speculative")
    eng = _port_engine(pcfg, port, 1)
    eng.prefill(_t([[1, 2, 3]]))
    with pytest.raises(ValueError, match="recurrent state"):
        eng.decode_step(_t([[4, 5, 6]]), advance=2)


def _port_cfg(ref_cfg):
    """A reference ArchConfig rebuilt from the port's own classes."""
    nested = {"attention": port_arch.AttentionSpec,
              "ffn": port_arch.FFNSpec, "ssm": port_arch.SSMSpec,
              "encoder": port_arch.EncoderSpec}
    fields = {}
    for f in dataclasses.fields(ref_cfg):
        v = getattr(ref_cfg, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**dataclasses.asdict(v))
        fields[f.name] = v
    return port_arch.ArchConfig(**fields)


def test_zamba2_is_not_ported():
    """Named when zamba2_1p2b raised; it is ported now: the port's
    ``init_model`` builds the reference's tree for it (Mamba2 and hybrid
    segments, the one ``shared_attn`` block), same shapes and dtypes, and
    its registry entry equals the reference config."""
    ref_cfg = get_config("zamba2_1p2b", reduced=True)
    cfg = _port_cfg(ref_cfg)
    assert cfg == port_config("zamba2_1p2b", reduced=True)
    ref = init_model(jax.random.PRNGKey(0), ref_cfg)
    port = port_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == r.shape
        assert p.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)


# ---------------------------------------------------------------------------
# the kernel's lane-group sum of y (emulated)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("states_per_lane", [2, 4])
@pytest.mark.parametrize("s", [1, 17, 48])
@pytest.mark.parametrize("ds", [5, 8, 16])
def test_scan_split_matches_reference(ds, s, states_per_lane):
    """y summed over the rounded lane group in the butterfly's order (ds 5:
    idle states in the last lane) against the reference's Pallas kernel in
    interpret mode, within 1e-5; the state is the plain recurrence's,
    bitwise."""
    args = _scan_inputs(2, s, 32, ds, seed=ds + s)
    yk, hk = ref_scan(*map(jnp.asarray, args), interpret=True)
    y, h = ops.selective_scan_split(*map(_t, args), states_per_lane)
    _close(y, yk)
    _close(h, hk)
    _, h_plain = ops.selective_scan_ref(*map(_t, args))
    assert torch.equal(h, h_plain)


@pytest.mark.parametrize("ds,states_per_lane,group",
                         [(1, 4, 1), (4, 4, 1), (5, 4, 2), (8, 4, 2),
                          (16, 4, 4), (16, 2, 8), (64, 4, 16), (64, 2, 32)])
def test_lane_group_rounds_up_to_a_power_of_two(ds, states_per_lane, group):
    assert ops.lane_group(ds, states_per_lane) == group
