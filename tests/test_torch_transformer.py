"""The port's ``forward`` against the reference's on the same weights and
inputs: logits, final hidden states and the caches it writes — prefill,
multi-position decode with scalar and per-row (b,) lengths, the dense
cache and the paged pool, and the port's kernel flag (its plain versions
on the CPU).  The MoE models (reduced granite, and reduced
llada_mini_like at E = 16 top-2) also match the summed aux loss; their
kernel flag runs the grouped FFN's plain version (f32 h) where the
reference forward runs ragged_dot.

Weights are float32 so the point is the algorithm; 1e-4 covers the
float32 rounding of reordered sums through two layers (observed ~4e-6)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.transformer import init_paged_cache as ref_paged  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import forward, init_cache, init_paged_cache  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m",
         "llada_mini_like"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    return cfg, port_config(request.param, reduced=True), params, port


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _cache_close(port_cache, ref_cache):
    for ps, rs in zip(port_cache["segments"], ref_cache["segments"]):
        for key in ("k", "v"):
            _close(ps[key], rs[key])


def test_train_mode_logits(model):
    cfg, pcfg, params, port = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    rl, _, ra, rh = ref_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    pl, _, pa, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)})
    _close(pl, rl)
    _close(ph, rh)
    _close(pa, ra)


@pytest.fixture(scope="module")
def prefilled(model):
    """A 3-row prefill in both stacks (the port's cache is cloned per use:
    decode writes it in place)."""
    cfg, pcfg, params, port = model
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 10))
    rl, rc, ra, rh = ref_forward(
        params, cfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
        cache=ref_init_cache(cfg, 3, 48, dtype=jnp.float32))
    pl, pc, pa, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                             mode="prefill",
                             cache=init_cache(pcfg, 3, 48, torch.float32,
                                              "cpu"))
    return rl, rc, rh, pl, pc, ph, ra, pa


def test_prefill_logits_hidden_cache(prefilled):
    rl, rc, rh, pl, pc, ph, ra, pa = prefilled
    _close(pl, rl)
    _close(ph, rh)
    _close(pa, ra)
    _cache_close(pc, rc)


@pytest.fixture(scope="module")
def ref_decode(model, prefilled):
    """Reference decode results by (n, per_row): the port's kernel flag
    does not change what they are compared with."""
    cfg, _, params, _ = model
    rc = prefilled[1]
    memo = {}

    def run(n, per_row):
        if (n, per_row) not in memo:
            lens = np.array([10, 4, 7], np.int32) if per_row else 10
            toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                     (3, n))
            rl, rc2, ra, rh = ref_forward(
                params, cfg, {"tokens": jnp.asarray(toks)}, mode="decode",
                cache=rc, cache_len=jnp.asarray(lens))
            memo[n, per_row] = (lens, toks, rl, rc2, rh, ra)
        return memo[n, per_row]
    return run


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("n", [1, 4])
def test_dense_decode(model, prefilled, ref_decode, n, per_row, use_kernel):
    """Multi-position decode after a prefill, at one shared length or at
    per-row lengths (the scheduler's slots)."""
    _, pcfg, _, port = model
    pc = jax.tree.map(torch.clone, prefilled[4])
    lens, toks, rl, rc2, rh, ra = ref_decode(n, per_row)
    pl, pc2, pa, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                             mode="decode", cache=pc,
                             cache_len=(torch.as_tensor(lens) if per_row
                                        else lens),
                             use_kernel=use_kernel)
    _close(pl, rl)
    _close(ph, rh)
    _close(pa, ra)
    _cache_close(pc2, rc2)


@pytest.fixture(scope="module")
def ref_paged_decode(model):
    """A fragmented float32 pool and the reference's paged decode over it,
    by n: per-row lengths, a row whose writes fall past its table (trash
    page) and an empty row."""
    cfg, _, params, _ = model
    memo = {}

    def run(n):
        if n not in memo:
            rng = np.random.default_rng(3)
            b, bs, max_blocks = 4, 8, 4
            n_phys = b * max_blocks + 1
            tables = rng.permutation(n_phys - 1)[:b * max_blocks].reshape(
                b, max_blocks).astype(np.int32)
            tables[3, 1:] = n_phys - 1                  # short reservation
            lens = np.array([0, 5, 17, 7], np.int32)
            pool = jax.tree.map(
                lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                      jnp.float32),
                ref_paged(cfg, n_phys, bs, dtype=jnp.float32))
            toks = rng.integers(0, cfg.vocab_size, (b, n))
            rl, rc, ra, rh = ref_forward(
                params, cfg, {"tokens": jnp.asarray(toks)}, mode="decode",
                cache=pool, cache_len=jnp.asarray(lens),
                block_tables=jnp.asarray(tables))
            memo[n] = (pool, tables, lens, toks, rl, rc, rh, ra)
        return memo[n]
    return run


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_paged_decode(model, ref_paged_decode, n, use_kernel):
    """Paged decode over a fragmented pool, against the reference."""
    _, pcfg, _, port = model
    pool, tables, lens, toks, rl, rc, rh, ra = ref_paged_decode(n)
    port_cache = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), pool)
    n_phys, bs = tables.size + 1, 8
    assert jax.tree.structure(port_cache) == jax.tree.structure(
        init_paged_cache(pcfg, n_phys, bs, torch.float32, "cpu"))
    pl, pc, pa, ph = forward(port, pcfg, {"tokens": torch.as_tensor(toks)},
                             mode="decode", cache=port_cache,
                             cache_len=torch.as_tensor(lens),
                             block_tables=torch.as_tensor(tables),
                             use_kernel=use_kernel)
    _close(pl, rl)
    _close(ph, rh)
    _close(pa, ra)
    # the trash page's winner among colliding junk writes is arbitrary
    for ps, rs in zip(pc["segments"], rc["segments"]):
        for key in ("k", "v"):
            _close(ps[key][:, :-1], rs[key][:, :-1])
