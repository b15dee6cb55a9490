"""The port's architecture registry against the reference's, and the
reduced starcoder2, phi3_medium and phi3_vision held against the
reference's forward.

Every ported config equals the reference's field by field, full and
reduced, with the same parameter count.  Reduced ``starcoder2_3b`` (GQA
g = 4, gelu), ``phi3_medium_14b`` (GQA g = 2) and ``phi3_vision_4p2b``
(MHA; also fed precomputed embeddings, its vision stub's interface) run
prefill then a multi-position decode at per-row lengths, over the dense
cache and a fragmented paged pool, with the kernel flag (its plain
versions on the CPU), against the reference on float32 weights at 1e-4
(reordered float32 sums through two layers; observed ~5e-6).

``_init`` draws a stacked leaf one layer slice at a time (a full-width
mixtral ``w_up`` is 6.4e9 elements: one f32 copy of the stack would not
fit beside the rest): the draws are checked through a patched
``torch.randn``."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import forward, init_cache, init_paged_cache  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ["minicpm3_4b", "mixtral_8x22b", "starcoder2_3b", "phi3_medium_14b",
       "phi3_vision_4p2b"]
GQA = ["starcoder2_3b", "phi3_medium_14b", "phi3_vision_4p2b"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference(arch, reduced):
    got, want = port_config(arch, reduced), get_config(arch, reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert list(got.pattern()) == list(want.pattern())


def test_registry_lists_the_ten_served_models():
    """Named when the port served ten of the reference's models; the
    registry now lists all twelve, the reference's ``ARCH_IDS`` and
    ``PAPER_IDS``, hybrid and encoder-decoder included."""
    from repro.configs import ARCH_IDS as REF_IDS, PAPER_IDS
    assert set(NEW) <= set(ARCH_IDS) and len(ARCH_IDS) == 12
    assert set(ARCH_IDS) == set(REF_IDS) | set(PAPER_IDS)
    assert port_config("zamba2_1p2b").family == "hybrid"
    assert port_config("whisper_tiny").encoder.n_frames == 1500
    with pytest.raises(ValueError, match="unknown architecture"):
        port_config("gpt2")


@pytest.mark.parametrize("arch", NEW + ["zamba2_1p2b", "whisper_tiny"])
def test_port_init_has_reference_layout(arch):
    """The port's own ``init_model`` builds the reference's tree for each
    model ported since the MoE and SSM slices (MLA leaves, the MoE's f32
    router, Mamba2's per-head f32 leaves, the shared attention block, the
    encoder): same structure, stacked shapes and dtypes (the values
    differ: another generator)."""
    from repro_torch.models import init_model as port_init
    ref = init_model(jax.random.PRNGKey(0), get_config(arch, reduced=True))
    port = port_init(port_config(arch, reduced=True),
                     torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == r.shape
        assert p.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)


@pytest.fixture(scope="module", params=GQA)
def model(request):
    cfg = get_config(request.param, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(request.param, reduced=True), params, port


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


B, S = 3, 48


@pytest.fixture(scope="module")
def prefilled(model):
    cfg, pcfg, params, port = model
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 10))
    rl, rc, _, rh = ref_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                                mode="prefill",
                                cache=ref_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    pl, pc, _, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                            mode="prefill",
                            cache=init_cache(pcfg, B, S, torch.float32, "cpu"))
    return toks, rl, rc, rh, pl, pc, ph


def test_prefill(prefilled):
    _, rl, rc, rh, pl, pc, ph = prefilled
    _close(pl, rl)
    _close(ph, rh)
    for key in ("k", "v"):
        _close(pc["segments"][0][key], rc["segments"][0][key])


def _to_pool(pc, tables, bs):
    """The dense prefilled cache (layers, B, S, kv, dh) copied into a pool
    whose rows live in the pages ``tables`` names."""
    n_blocks = S // bs
    n_phys = B * n_blocks + 1
    out = {}
    for key, src in pc["segments"][0].items():
        pool = torch.zeros((src.shape[0], n_phys, bs) + tuple(src.shape[3:]))
        for row in range(B):
            pool[:, torch.as_tensor(tables[row]).long()] = src[:, row].reshape(
                (src.shape[0], n_blocks, bs) + tuple(src.shape[3:]))
        out[key] = pool
    return {"segments": [out]}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [1, 4])
def test_decode(model, prefilled, n, use_kernel, paged):
    """Decode of n positions at per-row lengths after the prefill: logits
    and the written K/V equal the reference's dense decode."""
    cfg, pcfg, params, port = model
    _, _, rc, _, _, pc, _ = prefilled
    lens = np.array([10, 3, 7], np.int32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n))
    rl, rc2, _, _ = ref_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                                mode="decode", cache=rc,
                                cache_len=jnp.asarray(lens))
    bs = 8
    tables = np.random.default_rng(3).permutation(B * S // bs).reshape(
        B, S // bs).astype(np.int32)
    cache = (_to_pool(pc, tables, bs) if paged
             else {"segments": [{k: v.clone() for k, v in
                                 pc["segments"][0].items()}]})
    pl, pc2, _, _ = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                            mode="decode", cache=cache,
                            cache_len=torch.as_tensor(lens),
                            use_kernel=use_kernel,
                            block_tables=(torch.as_tensor(tables) if paged
                                          else None))
    _close(pl, rl)
    for key in ("k", "v"):
        got = pc2["segments"][0][key]
        if paged:                    # read the rows back through the table
            got = torch.stack([got[:, torch.as_tensor(tables[r]).long()]
                               .flatten(1, 2) for r in range(B)], dim=1)
        _close(got, rc2["segments"][0][key])


def test_paged_pool_layout():
    """A paged pool of each GQA model is (layers, n_phys, page, kv, dh)."""
    for arch in GQA:
        cfg = port_config(arch, reduced=True)
        pool = init_paged_cache(cfg, 5, 16, torch.float32, "cpu")
        a = cfg.attention
        assert tuple(pool["segments"][0]["k"].shape) == (
            cfg.n_layers, 5, 16, a.n_kv_heads, a.head_dim)


def test_phi3_vision_takes_embeddings():
    """The vision backbone's stub interface: precomputed embeddings in
    ``inputs["embeds"]`` give the reference's logits, and the token
    embeddings themselves give the token forward's."""
    arch = "phi3_vision_4p2b"
    cfg = get_config(arch, reduced=True)
    params = init_model(jax.random.PRNGKey(4), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    pcfg = port_config(arch, reduced=True)
    emb = np.random.default_rng(5).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    want = ref_forward(params, cfg, {"embeds": jnp.asarray(emb)})[0]
    _close(forward(port, pcfg, {"embeds": torch.as_tensor(emb)})[0], want)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 7)))
    by_tokens = forward(port, pcfg, {"tokens": toks})[0]
    by_embeds = forward(port, pcfg,
                        {"embeds": port["embed"]["table"][toks]})[0]
    assert torch.equal(by_tokens, by_embeds)


# ---------------------------------------------------------------------------
# _init: one layer slice per draw
# ---------------------------------------------------------------------------

def _record_draws(monkeypatch):
    shapes = []
    inner = torch.randn

    def randn(*args, **kw):
        out = inner(*args, **kw)
        shapes.append(tuple(out.shape))
        return out
    monkeypatch.setattr(torch, "randn", randn)
    return shapes


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_init_draws_one_slice_at_a_time(monkeypatch, lead):
    """A stacked leaf is drawn one ``shape`` slice per leading index (the
    f32 temporary is one slice); the leaf has the stacked shape, the
    requested type and the requested scale, and its slices differ."""
    shapes = _record_draws(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    shape, scale = (64, 48), 0.25
    w = layers._init(gen, shape, scale, torch.bfloat16, lead)
    count = int(np.prod(lead)) if lead else 1
    assert shapes == [shape] * count
    assert tuple(w.shape) == lead + shape and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) / scale - 1.0) < 0.05
    flat = w.view((-1,) + shape)
    if count > 1:
        assert not torch.equal(flat[0], flat[1])


def test_init_moe_draws_per_layer(monkeypatch):
    """Full-width mixtral's expert leaves, scaled down to two layers of a
    narrow model: every expert leaf is drawn per layer, never as a whole
    stack, at 1/sqrt(E)."""
    shapes = _record_draws(monkeypatch)
    ffn = dataclasses.replace(port_config("mixtral_8x22b").ffn, d_ff=64)
    p = port_moe.init_moe(torch.Generator().manual_seed(1), 32, ffn,
                          torch.bfloat16, lead=(2,))
    e = ffn.n_experts
    assert shapes.count((e, 32, 64)) == 4 and shapes.count((e, 64, 32)) == 2
    assert all(len(s) < 4 for s in shapes)        # no (2, e, ., .) draw
    for name in ("w_up", "w_gate", "w_down"):
        assert p[name].shape[0] == 2 and p[name].dtype == torch.bfloat16
        assert abs(float(p[name].float().std()) * e ** 0.5 - 1.0) < 0.05
    assert p["router"].dtype == torch.float32


def test_init_model_is_seeded():
    """The same generator seed gives the same weights."""
    cfg = port_config("mixtral_8x22b", reduced=True)
    from repro_torch.models import init_model as port_init
    a = port_init(cfg, torch.Generator().manual_seed(7), "cpu")
    b = port_init(cfg, torch.Generator().manual_seed(7), "cpu")
    wa, wb = a["segments"][0]["ffn"]["w_up"], b["segments"][0]["ffn"]["w_up"]
    assert torch.equal(wa, wb)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", [[], ["--kv-block-size", "16"]],
                         ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["greedy", "speculative"])
@pytest.mark.parametrize("arch", NEW)
def test_serve_cli(arch, mode, pool, capsys):
    """``serve --arch`` serves each new model at its reduced size on the
    CPU, greedy and speculative, dense and paged; no kernel launches (the
    plain versions run on the CPU)."""
    from repro_torch.launch.serve import build_parser, serve
    serve(build_parser().parse_args(
        ["--device", "cpu", "--tiny", "--arch", arch, "--requests", "3",
         "--slots", "2", "--tokens", "8", "--serve-mode", mode] + pool))
    out = capsys.readouterr().out
    assert "served 3 requests / 24 tokens" in out, out
    assert "decode_attention_dense 0, decode_attention_paged 0" in out
