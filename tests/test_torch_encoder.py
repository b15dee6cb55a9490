"""The port's encoder and cross-attention (whisper) against the
reference's: ``_sinusoidal``, ``encode``, ``encode_cross_kv`` and
``cross_attention``; reduced ``whisper_tiny`` through ``forward`` in
train, prefill and multi-position decode, at a scalar and at a per-row
``cache_len`` (the decoder's sinusoidal positions are offset by it); and
the engine's refusal of a model whose forward needs frame embeddings.

Everything is float32 with numpy-made inputs (the stub frontend's frame
embeddings among them).  Tolerances: the sinusoid 1e-5 absolute (the
same f32 products; sin and cos of angles up to ~40 rad may differ by an
ulp of the angle); the encoder, the cross-attention and the forward
1e-5 relative to the largest value, as the reference's own
prefill/decode-vs-full check (observed ~5e-7)."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.arch import AttentionSpec as RefAttentionSpec  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.attention import init_attention as ref_init_attention  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import arch as port_arch  # noqa: E402
from repro_torch.models import attention, forward, init_cache  # noqa: E402
from repro_torch.models import init_model as port_init  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

ARCH = "whisper_tiny"
REL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _max_rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.detach().numpy() - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    frames = np.random.default_rng(9).standard_normal(
        (3, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return cfg, port_config(ARCH, reduced=True), params, port, frames


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 384])
def test_sinusoidal_matches_reference(d):
    """(b, s) positions up to 40 (a decode offset per row) -> (b, s, d)."""
    pos = np.array([[0, 1, 2], [17, 18, 19], [38, 39, 40]], np.int32)
    want = ref_transformer._sinusoidal(jnp.asarray(pos), d)
    got = transformer._sinusoidal(_t(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_encode_matches_reference(model):
    """The encoder over 16 stub frames: sinusoidal positions, two
    non-causal layers with rotary, the final norm."""
    cfg, pcfg, params, port, frames = model
    want = ref_transformer.encode(params, cfg, jnp.asarray(frames))
    got = transformer.encode(port, pcfg, _t(frames))
    assert tuple(got.shape) == want.shape
    assert _max_rel(got, want) < REL


def test_encode_is_not_causal(model):
    """Changing the last frame moves the first frame's encoding."""
    _, pcfg, _, port, frames = model
    moved = frames.copy()
    moved[:, -1] += 1.0
    a = transformer.encode(port, pcfg, _t(frames))
    b = transformer.encode(port, pcfg, _t(moved))
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_cross_attention_matches_reference(heads):
    """``encode_cross_kv`` over a (2, 11, 32) memory and
    ``cross_attention`` of 5 query positions over it (every frame
    visible), MHA and GQA."""
    h, kv = heads
    a = port_arch.AttentionSpec(kind="gqa", n_heads=h, n_kv_heads=kv,
                                head_dim=8)
    ref_a = RefAttentionSpec(**dataclasses.asdict(a))
    params = ref_init_attention(jax.random.PRNGKey(3), 32, ref_a,
                                jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    memory = rng.standard_normal((2, 11, 32)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    rk, rv = ref_attention.encode_cross_kv(params, ref_a, jnp.asarray(memory))
    pk, pv = attention.encode_cross_kv(port, a, _t(memory))
    assert tuple(pk.shape) == rk.shape == (2, 11, kv, 8)
    assert _max_rel(pk, rk) < REL and _max_rel(pv, rv) < REL
    want = ref_attention.cross_attention(params, ref_a, jnp.asarray(x), rk, rv)
    got = attention.cross_attention(port, a, _t(x), pk, pv)
    assert _max_rel(got, want) < REL


def test_port_init_has_reference_layout(model):
    """The port's ``init_model`` builds the reference's tree for whisper:
    the stacked encoder layers and its final norm, each decoder layer's
    ``ln_cross`` and ``cross``; same shapes and dtypes."""
    cfg, pcfg, _, _, _ = model
    ref = init_model(jax.random.PRNGKey(0), cfg)
    port = port_init(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == r.shape
        assert p.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_train_logits_match_reference(model):
    cfg, pcfg, params, port, frames = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 9))
    rl, _, _, rh = ref_forward(params, cfg, {"tokens": jnp.asarray(toks),
                                             "frames": jnp.asarray(frames)})
    for use_kernel in (False, True):
        pl, _, pa, ph = forward(port, pcfg, {"tokens": _t(toks),
                                             "frames": _t(frames)},
                                use_kernel=use_kernel)
        assert _max_rel(pl, rl) < REL and _max_rel(ph, rh) < REL
        assert float(pa) == 0.0


@pytest.mark.parametrize("lens", ["scalar", "per_row"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_reference(model, use_kernel, lens):
    """Prefill of 3 rows, then a 4-position decode forward (every row at
    10, or at 10 / 6 / 8: per-row sinusoidal offsets and K/V writes),
    with the frames given again as the reference takes them: logits,
    hidden states and the K/V cache."""
    cfg, pcfg, params, port, frames = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 10))
    dec = rng.integers(0, cfg.vocab_size, (3, 4))
    fr, pfr = jnp.asarray(frames), _t(frames)
    rl, rc, _, rh = ref_forward(
        params, cfg, {"tokens": jnp.asarray(toks), "frames": fr},
        mode="prefill", cache=ref_init_cache(cfg, 3, 32, dtype=jnp.float32))
    pl, pc, _, ph = forward(port, pcfg, {"tokens": _t(toks), "frames": pfr},
                            mode="prefill",
                            cache=init_cache(pcfg, 3, 32, torch.float32,
                                             "cpu"),
                            use_kernel=use_kernel)
    assert _max_rel(pl, rl) < REL and _max_rel(ph, rh) < REL
    cl = [10, 6, 8] if lens == "per_row" else 10
    rl2, rc2, _, rh2 = ref_forward(
        params, cfg, {"tokens": jnp.asarray(dec), "frames": fr},
        mode="decode", cache=rc, cache_len=jnp.asarray(cl, jnp.int32))
    pl2, pc2, _, ph2 = forward(port, pcfg, {"tokens": _t(dec), "frames": pfr},
                               mode="decode", cache=pc,
                               cache_len=_t(np.array(cl, np.int32)),
                               use_kernel=use_kernel)
    assert _max_rel(pl2, rl2) < REL and _max_rel(ph2, rh2) < REL
    for r, p in zip(jax.tree.leaves(rc2), jax.tree.leaves(pc2)):
        assert _max_rel(p, r) < REL


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_then_decode_equals_full_forward(model, use_kernel):
    """Prefill 12 + decode 4 == the train forward's last 4 positions."""
    cfg, pcfg, _, port, frames = model
    toks = _t(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 16)))
    fr = _t(frames)
    full, _, _, _ = forward(port, pcfg, {"tokens": toks, "frames": fr},
                            use_kernel=use_kernel)
    _, cache, _, _ = forward(port, pcfg, {"tokens": toks[:, :12],
                                          "frames": fr},
                             mode="prefill",
                             cache=init_cache(pcfg, 3, 16, torch.float32,
                                              "cpu"),
                             use_kernel=use_kernel)
    dec, _, _, _ = forward(port, pcfg, {"tokens": toks[:, 12:], "frames": fr},
                           mode="decode", cache=cache, cache_len=12,
                           use_kernel=use_kernel)
    assert _max_rel(dec, full[:, 12:]) < REL


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_forward_without_frames_raises(model):
    _, pcfg, _, port, _ = model
    with pytest.raises(ValueError, match="frames"):
        forward(port, pcfg, {"tokens": _t([[1, 2, 3]])})


def test_engine_refuses_an_encoder_model(model):
    """No engine path passes frame embeddings (the reference's engine
    fails at its first prefill with KeyError: 'frames'): the port's
    DecodeEngine refuses the model when it is made."""
    cfg, pcfg, params, port, _ = model
    ref = RefEngine(cfg, params, batch=2, max_len=32,
                    cache=ref_init_cache(cfg, 2, 32, dtype=jnp.float32))
    with pytest.raises(KeyError, match="frames"):
        ref.prefill_slots({0: jnp.asarray([1, 2, 3])})
    with pytest.raises(ValueError, match="frames"):
        DecodeEngine(pcfg, port, batch=2, max_len=32, device="cpu")
