"""The port's multi-head latent attention (MLA, MiniCPM3 style) against the
reference's on the same weights: ``init_attention`` and the cache layout,
the non-absorbed prefill ``mla_full``, the absorbed decode ``mla_decode``
at a scalar and at per-row lengths, ``mla_decode_paged`` over a
fragmented pool, the absorbed-vs-prefill consistency through the whole
model, and ``ServingLoop`` streams of reduced ``minicpm3_4b`` (greedy and
speculative, dense and paged) equal to the reference's.  MLA has no
kernel in either stack, so the port's kernel flag changes nothing and
the scheduler reports no tile slack for it.

Weights and caches are float32, so the point is the algorithm: 1e-4
covers reordered float32 sums through two layers (observed ~2e-6)."""
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
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.transformer import init_paged_cache as ref_paged  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import PagedKVConfig as RefPaged  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import forward, init_cache, init_paged_cache  # noqa: E402
from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop  # noqa: E402

ARCH = "minicpm3_4b"
TOL = dict(atol=1e-4, rtol=1e-4)
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
D, B, S = 64, 3, 32


@pytest.fixture(scope="module")
def spec():
    """The reduced MLA geometry: 4 heads, q_lora 32, kv_lora 16, nope 16,
    rope 8, v 16."""
    return get_config(ARCH, reduced=True).attention, \
        port_config(ARCH, reduced=True).attention


@pytest.fixture(scope="module")
def layer(spec):
    """One MLA layer's float32 weights in both stacks."""
    ref_spec, _ = spec
    params = ref_attn.init_attention(jax.random.PRNGKey(3), D, ref_spec,
                                     dtype=jnp.float32)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _x(seed, n, b=B):
    return np.random.default_rng(seed).standard_normal((b, n, D)).astype(
        np.float32)


def _leaf_shapes(tree, lead=()):
    return {k: (_leaf_shapes(v, lead) if isinstance(v, dict)
                else lead + tuple(v.shape))
            for k, v in tree.items()}


def test_init_attention_leaves_and_scales(spec, layer):
    """Same leaves and shapes as the reference, stacked under a leading
    layer axis, each weight drawn at the reference's 1/sqrt(fan-in) and
    each norm scale at 1."""
    _, port_spec = spec
    ref_params, _ = layer
    got = port_attn.init_attention(torch.Generator().manual_seed(0), D,
                                   port_spec, torch.float32, lead=(2,))
    assert _leaf_shapes(got) == _leaf_shapes(ref_params, lead=(2,))
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        w = got[name]
        assert w.dtype == torch.float32
        # std of ~1e3+ draws within 15 % of 1/sqrt(fan-in)
        assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.15, name
    for name in ("q_norm", "kv_norm"):
        assert torch.equal(got[name]["scale"],
                           torch.ones_like(got[name]["scale"]))


def test_cache_shapes_match_reference(spec):
    """The dense cache and the paged pool hold the latent and the shared
    rotary key per position, as the reference's."""
    ref_spec, port_spec = spec
    dense = port_attn.init_kv_cache(B, S, port_spec, torch.float32)
    want = ref_attn.init_kv_cache(B, S, ref_spec)
    assert {k: tuple(v.shape) for k, v in dense.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    pool = port_attn.init_kv_cache(9, 16, port_spec, torch.float32)
    want = ref_attn.init_paged_kv_cache(9, 16, ref_spec)
    assert {k: tuple(v.shape) for k, v in pool.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    cfg = port_config(ARCH, reduced=True)
    full = init_cache(cfg, B, S, torch.float32, "cpu")
    paged = init_paged_cache(cfg, 9, 16, torch.float32, "cpu")
    assert tuple(full["segments"][0]["latent"].shape) == (2, B, S, 16)
    assert tuple(paged["segments"][0]["k_rope"].shape) == (2, 9, 16, 8)


def test_mla_full_and_build_cache(spec, layer):
    """Non-absorbed prefill output and the latent / rotary key it writes
    (at a nonzero offset) equal the reference's."""
    ref_spec, port_spec = spec
    ref_params, port_params = layer
    x = _x(0, 10)
    pos = np.tile(np.arange(10, dtype=np.int32), (B, 1))
    r_out, r_cache = ref_attn.mla_full(
        ref_params, ref_spec, jnp.asarray(x), jnp.asarray(pos), 10000.0,
        ref_attn.init_kv_cache(B, S, ref_spec, jnp.float32), cache_len=5)
    cache = port_attn.init_kv_cache(B, S, port_spec, torch.float32)
    p_out, p_cache = port_attn.mla_full(
        port_params, port_spec, torch.as_tensor(x), torch.as_tensor(pos),
        10000.0, cache, cache_len=5)
    _close(p_out, r_out)
    assert p_cache is cache                       # written in place
    for key in ("latent", "k_rope"):
        _close(p_cache[key], r_cache[key])


@pytest.fixture(scope="module")
def prefilled(spec, layer):
    """A 3-row prefill of 12 positions in both stacks."""
    ref_spec, port_spec = spec
    ref_params, port_params = layer
    x = _x(1, 12)
    pos = np.tile(np.arange(12, dtype=np.int32), (B, 1))
    _, rc = ref_attn.mla_full(ref_params, ref_spec, jnp.asarray(x),
                              jnp.asarray(pos), 10000.0,
                              ref_attn.init_kv_cache(B, S, ref_spec,
                                                     jnp.float32))
    pc = port_attn.init_kv_cache(B, S, port_spec, torch.float32)
    port_attn.mla_full(port_params, port_spec, torch.as_tensor(x),
                       torch.as_tensor(pos), 10000.0, pc)
    return rc, pc


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("n", [1, 4])
def test_mla_decode(spec, layer, prefilled, n, per_row):
    """Absorbed decode of n positions at one shared length or at per-row
    lengths: output and the in-place cache writes equal the reference's."""
    ref_spec, port_spec = spec
    ref_params, port_params = layer
    rc, pc = prefilled
    pc = {k: v.clone() for k, v in pc.items()}
    lens = np.array([12, 4, 9], np.int32) if per_row else 12
    x = _x(2, n)
    r_out, r_cache = ref_attn.mla_decode(ref_params, ref_spec,
                                         jnp.asarray(x), rc,
                                         jnp.asarray(lens), 10000.0)
    p_out, p_cache = port_attn.mla_decode(
        port_params, port_spec, torch.as_tensor(x), pc,
        torch.as_tensor(lens) if per_row else lens, 10000.0)
    _close(p_out, r_out)
    assert p_cache is pc
    for key in ("latent", "k_rope"):
        _close(p_cache[key], r_cache[key])


@pytest.mark.parametrize("n", [1, 4])
def test_mla_decode_paged(spec, layer, n):
    """Paged absorbed decode over a fragmented pool (rows at lengths 0,
    13 and 17, one page each boundary-crossing) equals the reference's,
    output and pool."""
    ref_spec, port_spec = spec
    ref_params, port_params = layer
    bs, max_blocks, n_phys = 8, 4, 13
    rng = np.random.default_rng(4)
    pools = {"latent": rng.standard_normal((n_phys, bs, 16)),
             "k_rope": rng.standard_normal((n_phys, bs, 8))}
    pools = {k: v.astype(np.float32) for k, v in pools.items()}
    tables = rng.permutation(n_phys - 1)[:B * max_blocks].reshape(
        B, max_blocks).astype(np.int32)
    lens = np.array([0, 13, 17], np.int32)
    x = _x(5, n)
    r_out, r_pool = ref_attn.mla_decode_paged(
        ref_params, ref_spec, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(lens),
        jnp.asarray(tables), 10000.0)
    pc = {k: torch.as_tensor(v.copy()) for k, v in pools.items()}
    p_out, p_pool = port_attn.attention_decode(
        port_params, port_spec, torch.as_tensor(x), pc,
        torch.as_tensor(lens), 10000.0, use_kernel=True,
        block_tables=torch.as_tensor(tables))
    _close(p_out, r_out)
    assert p_pool is pc
    for key in ("latent", "k_rope"):
        _close(p_pool[key], r_pool[key])


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    params = init_model(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(ARCH, reduced=True), params, port


def test_forward_matches_reference(model):
    """Prefill then a per-row decode through the whole model, dense and
    paged, against the reference's logits, hidden states and caches."""
    cfg, pcfg, params, port = model
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 10))
    rl, rc, _, rh = ref_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                                mode="prefill",
                                cache=ref_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    pl, pc, _, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                            mode="prefill",
                            cache=init_cache(pcfg, B, S, torch.float32,
                                             "cpu"))
    _close(pl, rl)
    _close(ph, rh)
    lens = np.array([10, 3, 7], np.int32)
    nxt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 4))
    rl, rc2, _, _ = ref_forward(params, cfg, {"tokens": jnp.asarray(nxt)},
                                mode="decode", cache=rc,
                                cache_len=jnp.asarray(lens))
    pl, pc2, _, _ = forward(port, pcfg, {"tokens": torch.as_tensor(nxt)},
                            mode="decode", cache=pc,
                            cache_len=torch.as_tensor(lens), use_kernel=True)
    _close(pl, rl)
    for key in ("latent", "k_rope"):
        _close(pc2["segments"][0][key], rc2["segments"][0][key])
    # the same decode over a paged pool holding the same rows in
    # scattered pages gives the reference's dense logits
    bs, n_blocks = 8, S // 8
    n_phys = B * n_blocks + 1
    tables = np.random.default_rng(8).permutation(n_phys - 1).reshape(
        B, n_blocks).astype(np.int32)
    pool = init_paged_cache(pcfg, n_phys, bs, torch.float32, "cpu")
    for key, leaf in pool["segments"][0].items():
        src = pc["segments"][0][key]            # (layers, B, S, .)
        for row in range(B):
            leaf[:, torch.as_tensor(tables[row]).long()] = \
                src[:, row].reshape(src.shape[0], n_blocks, bs, -1)
    pl_p, _, _, _ = forward(port, pcfg, {"tokens": torch.as_tensor(nxt)},
                            mode="decode", cache=pool,
                            cache_len=torch.as_tensor(lens),
                            block_tables=torch.as_tensor(tables))
    _close(pl_p, rl)


def test_absorbed_decode_matches_prefill(model):
    """The port's absorbed decode after a non-absorbed prefill gives the
    logits of one non-absorbed forward over the whole sequence (the
    reference's ``test_mla_consistency_f32``, at its 1e-4)."""
    _, pcfg, _, port = model
    b, s, n = 2, 12, 4
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, pcfg.vocab_size, (b, s + n)))
    full = forward(port, pcfg, {"tokens": toks})[0]
    cache = init_cache(pcfg, b, s + n, torch.float32, "cpu")
    _, cache, _, _ = forward(port, pcfg, {"tokens": toks[:, :s]},
                             mode="prefill", cache=cache)
    dec = forward(port, pcfg, {"tokens": toks[:, s:]}, mode="decode",
                  cache=cache, cache_len=s)[0]
    a, c = full[:, s:].numpy(), dec.numpy()
    assert np.max(np.abs(a - c)) / (np.max(np.abs(a)) + 1e-9) < 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

MAX_LEN, SLOTS, TOKENS = 64, 2, 8


def _prompts(vocab):
    """Five prompts; the last shares its first 16 tokens (one page) with
    the second and is admitted later, so the paged runs hit."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(4, 14)))
               for _ in range(3)]
    shared = rng.integers(0, vocab, size=20)
    prompts.insert(1, shared)
    prompts.append(np.concatenate([shared[:16], rng.integers(0, vocab, 5)]))
    return prompts


def _ref_streams(cfg, params, mode, block_size):
    if block_size:
        n_phys = SLOTS * MAX_LEN // block_size + 1
        eng = RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                        paged=RefPaged(block_size=block_size),
                        cache=ref_paged(cfg, n_phys, block_size,
                                        dtype=jnp.float32))
    else:
        eng = RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                        cache=ref_init_cache(cfg, SLOTS, MAX_LEN,
                                             dtype=jnp.float32))
    loop = RefLoop(eng, mode=mode)
    for p in _prompts(cfg.vocab_size):
        loop.submit(p, TOKENS)
    return loop.run()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("block_size", [0, 16], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_serving_streams_match_reference(model, monkeypatch, mode,
                                         block_size, use_kernel):
    """Reduced minicpm3_4b served by both stacks: byte-identical streams.
    The kernel flag changes nothing for MLA, and no forward reports tile
    slack (the decode kernel does not serve MLA)."""
    cfg, pcfg, params, port = model
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))
    want = _ref_streams(cfg, params, mode, block_size)
    eng = DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN, hardware=HW,
                       use_kernel=use_kernel, device="cpu",
                       paged=(PagedKVConfig(block_size=block_size)
                              if block_size else None))
    loop = ServingLoop(eng, mode=mode)
    for p in _prompts(cfg.vocab_size):
        loop.submit(p, TOKENS)
    got = loop.run()
    assert got.keys() == want.keys()
    for rid in want:
        assert np.array_equal(got[rid], np.asarray(want[rid])), rid
    assert not any("kv_tile_util" in e for e in loop.step_log)
    if block_size:
        assert loop.stats()["prefix_hits"] >= 1


def test_attn_slack_is_none_for_mla(model):
    """A kernel-flagged MLA engine models no tile slack, as the
    reference's ``_attn_slack`` (``a.kind == "mla"``); a GQA engine
    still does."""
    _, pcfg, _, port = model
    eng = DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN,
                       use_kernel=True, device="cpu")
    loop = ServingLoop(eng, mode="greedy")
    loop.submit(np.arange(5), 2)
    loop.admit()
    assert loop._attn_slack(1) is None
    gcfg = port_config("stablelm_3b", reduced=True)
    from repro_torch.models import init_model as port_init
    gqa = DecodeEngine(gcfg, port_init(gcfg, torch.Generator(), "cpu",
                                       torch.float32),
                       batch=SLOTS, max_len=MAX_LEN, use_kernel=True,
                       device="cpu")
    gloop = ServingLoop(gqa, mode="greedy")
    gloop.submit(np.arange(5), 2)
    gloop.admit()
    assert gloop._attn_slack(1)["kv_tiles_executed"] > 0
