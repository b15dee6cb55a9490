"""The port's sliding-window attention against the reference's on the same
weights: the window masks old tokens, ``gqa_decode_ring`` (the O(window)
ring buffer) across its wraparound seam and the slot each position lands
in, ``forward(swa_ring=True)`` against the full cache over the
reference's block schedule, the ring's sizing in ``init_cache``, its
refusal of per-row lengths, and ``ServingLoop`` streams of reduced
``mixtral_8x22b`` (window 8, E 4 top-2) running well past the window,
with the port's kernel flag on (its plain versions on the CPU) and off.

Weights and caches are float32.  The ring holds its keys in another order
than the full cache, so the two sum in other orders: 1e-5 relative, as
the reference's ``test_swa_ring_buffer_matches_full_cache``, and 1e-5
between the two stacks' ring layers (observed ~1e-6)."""
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
from repro.core.arch import AttentionSpec as RefSpec  # noqa: E402
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
from repro_torch.core.arch import AttentionSpec  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import forward, init_cache  # noqa: E402
from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop  # noqa: E402

ARCH = "mixtral_8x22b"
RING_RTOL = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)              # window 8
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(ARCH, reduced=True), params, port


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_window_masks_old_tokens(model):
    """The last position of 20 does not see a token 17 positions back
    (window 8): its logits do not move when that token changes, and both
    runs equal the reference's logits."""
    cfg, pcfg, params, port = model
    t1 = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 20))
    t2 = t1.copy()
    t2[0, 2] = (t2[0, 2] + 1) % cfg.vocab_size
    l1 = forward(port, pcfg, {"tokens": torch.as_tensor(t1)})[0]
    l2 = forward(port, pcfg, {"tokens": torch.as_tensor(t2)})[0]
    np.testing.assert_allclose(l1[0, -1].numpy(), l2[0, -1].numpy(),
                               atol=1e-5)
    assert not torch.allclose(l1[0, 2], l2[0, 2])
    for toks, got in ((t1, l1), (t2, l2)):
        _close(got, ref_forward(params, cfg, {"tokens": jnp.asarray(toks)})[0])


SEAM = dict(d=64, b=2, n=4, w_buf=48, s_full=192)


def _seam_layer():
    a = dict(kind="swa", n_heads=4, n_kv_heads=2, head_dim=32, window=32)
    params = ref_attn.init_attention(jax.random.PRNGKey(5), SEAM["d"],
                                     RefSpec(**a), dtype=jnp.float32)
    return (RefSpec(**a), params, AttentionSpec(**a),
            params_from_jax(jax.tree.map(np.asarray, params)))


def test_ring_decode_matches_reference_across_seam():
    """The ring and the full-cache SWA decode driven in lockstep past
    three wraparounds of a 48-slot ring (window 32, 4 positions a step):
    the port's ring equals the reference's ring (output and every slot)
    and the port's own full-cache decode at every step, including the
    steps whose window spans the seam."""
    ref_spec, ref_params, spec, params = _seam_layer()
    d, b, n, w_buf, s_full = (SEAM[k] for k in ("d", "b", "n", "w_buf",
                                                "s_full"))
    z = np.zeros((b, w_buf, 2, 32), np.float32)
    r_ring = {"k": jnp.asarray(z), "v": jnp.asarray(z)}
    ring = {"k": torch.zeros(b, w_buf, 2, 32), "v": torch.zeros(b, w_buf, 2, 32)}
    full = {"k": torch.zeros(b, s_full, 2, 32),
            "v": torch.zeros(b, s_full, 2, 32)}
    wrapped = False
    for step in range((s_full - n) // n):
        cl = step * n
        x = np.random.default_rng(step).standard_normal((b, n, d)).astype(
            np.float32)
        r_out, r_ring = ref_attn.gqa_decode_ring(ref_params, ref_spec,
                                                 jnp.asarray(x), r_ring, cl,
                                                 10000.0)
        out, got = port_attn.gqa_decode_ring(params, spec, torch.as_tensor(x),
                                             ring, cl, 10000.0)
        assert got is ring                        # written in place
        out_f, _ = port_attn.gqa_decode(params, spec, torch.as_tensor(x),
                                        full, cl, 10000.0)
        _close(out, r_out)
        _close(ring["k"], r_ring["k"])
        _close(ring["v"], r_ring["v"])
        np.testing.assert_allclose(out.numpy(), out_f.numpy(), **TOL,
                                   err_msg=f"step {step}")
        wrapped |= cl + n > w_buf
    assert wrapped


def test_ring_wraparound_slot_contents():
    """After several full wraps each slot holds the LARGEST position
    congruent to it: slot s equals the full cache's K/V at that position
    (and every slot was written)."""
    _, _, spec, params = _seam_layer()
    d, b, n, w_buf = SEAM["d"], 1, 2, 16
    total = 3 * w_buf + 6
    ring = {"k": torch.zeros(b, w_buf, 2, 32), "v": torch.zeros(b, w_buf, 2, 32)}
    full = {"k": torch.zeros(b, total, 2, 32), "v": torch.zeros(b, total, 2, 32)}
    for cl in range(0, total, n):
        x = torch.as_tensor(np.random.default_rng(cl).standard_normal(
            (b, n, d)).astype(np.float32))
        port_attn.gqa_decode_ring(params, spec, x, ring, cl, 10000.0)
        port_attn.gqa_decode(params, spec, x, full, cl, 10000.0)
    for slot in range(w_buf):
        p = slot + w_buf * ((total - 1 - slot) // w_buf)
        assert p % w_buf == slot and total - w_buf <= p < total
        for key in ("k", "v"):
            assert torch.equal(ring[key][:, slot], full[key][:, p]), (slot, p)


BLOCKS = [1, 3, 2, 4, 1, 5, 8, 2, 6, 3, 5]


def test_forward_ring_matches_full_cache(model):
    """``forward(swa_ring=True)`` on ``init_cache(swa_ring=True)`` (window
    8 + headroom 8 -> a 16-slot ring) against the 64-position full cache
    over the reference's block schedule (40 positions, blocks of 1-8, two
    wraps), at 1e-5 relative; and the port's ring logits equal the
    reference's ring logits."""
    cfg, pcfg, params, port = model
    b, total = 2, sum(BLOCKS)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, total))

    def run(swa_ring):
        cache = init_cache(pcfg, b, 64, torch.float32, "cpu",
                           swa_ring=swa_ring, ring_headroom=8)
        assert cache["segments"][0]["k"].shape[2] == (16 if swa_ring
                                                      else 64)
        outs, pos = [], 0
        for nb in BLOCKS:
            lg, cache, _, _ = forward(
                port, pcfg, {"tokens": torch.as_tensor(toks[:, pos:pos + nb])},
                mode="decode", cache=cache, cache_len=pos, swa_ring=swa_ring)
            outs.append(lg.numpy())
            pos += nb
        return np.concatenate(outs, axis=1)

    def ref_run():
        cache = ref_init_cache(cfg, b, 64, dtype=jnp.float32, swa_ring=True,
                               ring_headroom=8)
        outs, pos = [], 0
        for nb in BLOCKS:
            lg, cache, _, _ = ref_forward(
                params, cfg, {"tokens": jnp.asarray(toks[:, pos:pos + nb])},
                mode="decode", cache=cache,
                cache_len=jnp.asarray(pos, jnp.int32), swa_ring=True)
            outs.append(np.asarray(lg))
            pos += nb
        return np.concatenate(outs, axis=1)

    full, ring = run(False), run(True)
    err = np.max(np.abs(full - ring)) / (np.max(np.abs(full)) + 1e-9)
    assert err < RING_RTOL, err
    np.testing.assert_allclose(ring, ref_run(), **TOL)


def test_ring_sizing_and_per_row_lengths():
    """The ring holds window + headroom positions rounded up to 16, capped
    at max_len, as the reference's (full-width mixtral: 4096 + 128 ->
    4224); a GQA model keeps its full cache; a (b,) length raises."""
    cfg = dataclasses.replace(port_config(ARCH), n_layers=1)
    ref_cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    for max_len, want in ((4608, 4224), (4000, 4000)):
        got = init_cache(cfg, 1, max_len, device="cpu", swa_ring=True)
        ref = ref_init_cache(ref_cfg, 1, max_len, swa_ring=True)
        assert got["segments"][0]["k"].shape[2] == want
        assert ref["segments"][0]["k"].shape[2] == want
    small = init_cache(cfg, 1, 4608, device="cpu", swa_ring=True,
                       ring_headroom=1)
    assert small["segments"][0]["k"].shape[2] == 4112      # 4097 -> 4112
    gqa = port_config("starcoder2_3b", reduced=True)
    assert init_cache(gqa, 1, 64, device="cpu", swa_ring=True)[
        "segments"][0]["k"].shape[2] == 64
    _, _, spec, params = _seam_layer()
    ring = {"k": torch.zeros(2, 48, 2, 32), "v": torch.zeros(2, 48, 2, 32)}
    x = torch.zeros(2, 1, SEAM["d"])
    with pytest.raises(ValueError, match="scalar"):
        port_attn.gqa_decode_ring(params, spec, x, ring,
                                  torch.tensor([3, 4]), 10000.0)


# ---------------------------------------------------------------------------
# serving past the window
# ---------------------------------------------------------------------------

MAX_LEN, SLOTS, TOKENS = 64, 2, 12


def _prompts(vocab):
    """Five prompts of 4-20 tokens (every stream ends past the window of
    8); the last shares its first 16 tokens (one page) with the second and
    is admitted later, so the paged runs hit."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(4, 14)))
               for _ in range(3)]
    shared = rng.integers(0, vocab, size=20)
    prompts.insert(1, shared)
    prompts.append(np.concatenate([shared[:16], rng.integers(0, vocab, 5)]))
    return prompts


@pytest.fixture(scope="module")
def ref_streams(model):
    cfg, _, params, _ = model
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "init_cache",
                   functools.partial(ref_init_cache, dtype=jnp.float32))
        for mode in ("greedy", "speculative"):
            for bs in (0, 16):
                if bs:
                    eng = RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                                    paged=RefPaged(block_size=bs),
                                    cache=ref_paged(cfg,
                                                    SLOTS * MAX_LEN // bs + 1,
                                                    bs, dtype=jnp.float32))
                else:
                    eng = RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                                    cache=ref_init_cache(cfg, SLOTS, MAX_LEN,
                                                         dtype=jnp.float32))
                loop = RefLoop(eng, mode=mode)
                for p in _prompts(cfg.vocab_size):
                    loop.submit(p, TOKENS)
                out[mode, bs] = loop.run()
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("block_size", [0, 16], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_serving_streams_match_reference(model, ref_streams, mode,
                                         block_size, use_kernel):
    """Reduced mixtral served by both stacks, every stream reaching 16-32
    positions against a window of 8: byte-identical streams, and with the
    kernel flag every forward models its windowed tile slack."""
    cfg, pcfg, _, port = model
    eng = DecodeEngine(pcfg, port, batch=SLOTS, max_len=MAX_LEN, hardware=HW,
                       use_kernel=use_kernel, device="cpu",
                       paged=(PagedKVConfig(block_size=block_size)
                              if block_size else None))
    loop = ServingLoop(eng, mode=mode)
    prompts = _prompts(cfg.vocab_size)
    for p in prompts:
        loop.submit(p, TOKENS)
    got = loop.run()
    want = ref_streams[mode, block_size]
    assert got.keys() == want.keys()
    for rid in want:
        assert np.array_equal(got[rid], np.asarray(want[rid])), rid
    assert min(len(p) for p in prompts) + TOKENS >= 2 * pcfg.attention.window
    assert all(("kv_tile_util" in e) == use_kernel for e in loop.step_log)
