"""Each layer function of the port against its reference on the same
inputs.  Tolerances: float32 inputs agree to float32 rounding (1e-5 —
only the order of sums differs); bf16 inputs agree within one bf16 step
(2^-7 relative) — both frameworks compute internally in float32 and round
once, but XLA may keep excess precision between fused bf16 ops."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as ref  # noqa: E402
from repro_torch.models import layers as port  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7, 2.0 ** -7)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt, _, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


def _close(got, want, dtype: str):
    _, _, atol, rtol = DTYPES[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(rng, dtype):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    sj, st = _pair(scale, dtype)
    _close(port.rmsnorm({"scale": st}, xt), ref.rmsnorm({"scale": sj}, xj),
           dtype)


@pytest.mark.parametrize("head_dim", [16, 80, 128])
def test_rope_frequencies(head_dim):
    np.testing.assert_allclose(
        port.rope_frequencies(head_dim, 10000.0).numpy(),
        np.asarray(ref.rope_frequencies(head_dim, 10000.0)), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(rng, dtype):
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = (np.arange(6)[None] + np.array([[0], [37]])).astype(np.int32)
    xj, xt = _pair(x, dtype)
    _close(port.apply_rope(xt, torch.as_tensor(pos)),
           ref.apply_rope(xj, jnp.asarray(pos)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp(rng, activation, dtype):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("up", (64, 128)), ("down", (128, 64)),
                      ("gate", (64, 128)))}
    if activation == "gelu":
        del w["gate"]
    xj, xt = _pair(x, dtype)
    pj = {k: _pair(v, dtype)[0] for k, v in w.items()}
    pt = {k: _pair(v, dtype)[1] for k, v in w.items()}
    # one more bf16 rounding (h) feeds the down projection
    _close(port.mlp(pt, xt, activation), ref.mlp(pj, xj, activation), dtype)


def test_embed(rng):
    table = rng.standard_normal((256, 64)).astype(np.float32)
    toks = rng.integers(0, 256, size=(2, 7))
    np.testing.assert_array_equal(
        port.embed({"table": torch.as_tensor(table)},
                   torch.as_tensor(toks)).numpy(),
        np.asarray(ref.embed({"table": jnp.asarray(table)},
                             jnp.asarray(toks))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_head_and_tied_unembed(rng, dtype):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) / 8).astype(np.float32)
    table = (rng.standard_normal((256, 64)) / 8).astype(np.float32)
    xj, xt = _pair(x, dtype)
    _close(port.lm_head({"w": _pair(w, dtype)[1]}, xt),
           ref.lm_head({"w": _pair(w, dtype)[0]}, xj), dtype)
    _close(port.unembed_tied({"table": _pair(table, dtype)[1]}, xt),
           ref.unembed_tied({"table": _pair(table, dtype)[0]}, xj), dtype)
