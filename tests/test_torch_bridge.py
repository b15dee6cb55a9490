"""The weight bridge: the reference's parameter pytree -> the port's
tensors, leaf for leaf and bit for bit."""
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

ARCHS = ["stablelm_3b", "wedlm8b_like"]


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
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    for ref, got in zip(jax.tree.leaves(leaves), jax.tree.leaves(port)):
        assert got.dtype == want and tuple(got.shape) == ref.shape
        ref_bits = (ref.view(np.int16) if dtype == jnp.bfloat16
                    else ref.view(np.int32))
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
        assert tuple(p.shape) == r.shape and p.dtype == torch.bfloat16
