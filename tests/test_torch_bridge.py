"""The weight bridge: the reference's parameter pytree -> the port's
tensors, leaf for leaf and bit for bit (an MoE tree keeps its f32 router
inside bf16 expert leaves)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import init_model as port_init_model  # noqa: E402

ARCHS = ["stablelm_3b", "wedlm8b_like", "granite_moe_3b_a800m"]


def _bits(t: "torch.Tensor") -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_bit_exact(arch, dtype):
    """Every leaf crosses with its structure, shape, dtype and bits."""
    cfg = get_config(arch, reduced=True)
    leaves = jax.tree.map(np.asarray,
                          init_model(jax.random.PRNGKey(0), cfg, dtype=dtype))
    port = params_from_jax(leaves)
    assert jax.tree.structure(port) == jax.tree.structure(leaves)
    for ref, got in zip(jax.tree.leaves(leaves), jax.tree.leaves(port)):
        bf16 = ref.dtype.name == "bfloat16"
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert tuple(got.shape) == ref.shape
        ref_bits = ref.view(np.int16) if bf16 else ref.view(np.int32)
        np.testing.assert_array_equal(_bits(got), ref_bits)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_reference_layout(arch):
    """The port's own init_model builds the reference's tree: same keys,
    stacked shapes and dtypes (the values differ: another generator)."""
    ref = init_model(jax.random.PRNGKey(0), get_config(arch, reduced=True))
    port = port_init_model(port_config(arch, reduced=True),
                           torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for r, p in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert tuple(p.shape) == r.shape
        assert p.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)


def test_moe_leaves_cross_with_an_f32_router():
    """granite's bf16 tree: the stacked router stays f32 across the bridge,
    every expert leaf bf16, bits unchanged."""
    cfg = get_config("granite_moe_3b_a800m", reduced=True)
    leaves = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(1), cfg))
    ffn = params_from_jax(leaves)["segments"][0]["ffn"]
    ref = leaves["segments"][0]["ffn"]
    assert sorted(ffn) == ["router", "w_down", "w_gate", "w_up"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].shape == (cfg.n_layers, cfg.d_model,
                                   cfg.ffn.n_experts)
    np.testing.assert_array_equal(ffn["router"].numpy(), ref["router"])
    for key in ("w_up", "w_gate", "w_down"):
        assert ffn[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(ffn[key]),
                                      ref[key].view(np.int16))
