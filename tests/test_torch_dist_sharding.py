"""The port's sharding rules against the reference's, leaf for leaf.

Seven configs at full size (shapes only: ``jax.eval_shape`` for the
reference, ``FakeTensorMode`` for the port) on the reference tests'
duck-typed single-pod (16 x 16) and multi-pod (2 x 16 x 16) meshes: the
param specs under all four policies, the optimizer specs with and
without the ZeRO-2 upgrade, the cache specs in both modes, the batch
specs, the leaf names the role rules read, and the per-device shapes.
Then the reference's own ``tests/test_dist_sharding.py`` cases on the
port.  Pure spec logic: no process group.
"""
from __future__ import annotations

import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.dist import sharding as ref  # noqa: E402
from repro.models.transformer import init_cache as ref_init_cache  # noqa: E402
from repro.models.transformer import init_model as ref_init_model  # noqa: E402
from repro.training import init_opt_state as ref_init_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import leaves_with_paths  # noqa: E402
from repro_torch.dist import sharding as port  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch.specs import (cache_abstract, opt_abstract,  # noqa: E402
                                      params_abstract)


class FakeMesh:
    """The reference tests' duck-typed mesh."""

    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.shape = dict(shape_map)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}
ARCHS = ("stablelm_3b", "granite_moe_3b_a800m", "falcon_mamba_7b",
         "minicpm3_4b", "zamba2_1p2b", "whisper_tiny", "phi3_vision_4p2b")
POLICIES = ("fsdp", "auto", "tp_only", "dp_only")
CACHE_BATCH, CACHE_LEN = 64, 4096


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference params, opt, cache; port params, opt, cache), abstract."""
    cfg = ref_config(arch)
    r_params = jax.eval_shape(lambda k: ref_init_model(k, cfg),
                              jax.random.PRNGKey(0))
    r_opt = jax.eval_shape(ref_init_opt, r_params)
    r_cache = jax.eval_shape(lambda: ref_init_cache(cfg, CACHE_BATCH,
                                                    CACHE_LEN))
    pcfg = get_config(arch)
    p_params = params_abstract(pcfg)
    return (r_params, r_opt, r_cache, p_params, opt_abstract(p_params),
            cache_abstract(pcfg, CACHE_BATCH, CACHE_LEN))


def _ref_specs(tree):
    return [(jax.tree_util.keystr(path), tuple(s)) for path, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [("".join(f"[{p!r}]" for p in path), tuple(s))
            for path, s in leaves_with_paths(tree, (), port.is_spec)]


def _same(port_tree, ref_tree):
    got, want = _port_specs(port_tree), _ref_specs(ref_tree)
    assert len(got) == len(want) > 0
    assert got == want


# ---------------------------------------------------------------------------
# leaf for leaf against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_pspecs_equal_the_reference(arch, mesh, policy):
    r_params, r_opt, _, p_params, p_opt, _ = trees(arch)
    m = MESHES[mesh]
    r_ps = ref.param_pspecs(r_params, m, policy=policy)
    p_ps = port.param_pspecs(p_params, m, policy=policy)
    _same(p_ps, r_ps)
    _same(port.opt_pspecs(p_opt, p_ps), ref.opt_pspecs(r_opt, r_ps))
    _same(port.opt_pspecs(p_opt, p_ps, m), ref.opt_pspecs(r_opt, r_ps, m))


@pytest.mark.parametrize("mode", ("head", "seq"))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(arch, mesh, mode):
    _, _, r_cache, _, _, p_cache = trees(arch)
    m = MESHES[mesh]
    _same(port.cache_pspecs(p_cache, m, CACHE_BATCH, mode=mode),
          ref.cache_pspecs(r_cache, m, CACHE_BATCH, mode=mode))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_pspec_equals_the_reference(mesh):
    m = MESHES[mesh]
    for batch in (1, 2, 3, 8, 16, 32, 48, 64, 128, 256, 512, 1024):
        for include_model in (False, True):
            assert tuple(port.batch_pspec(m, batch, include_model)) == \
                tuple(ref.batch_pspec(m, batch, include_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_names_are_the_reference_keystr(arch):
    r_params, _, _, p_params, _, _ = trees(arch)
    want = [jax.tree_util.keystr(p).lower()
            for p, _ in jax.tree_util.tree_leaves_with_path(r_params)]
    got = [port.leaf_name(p) for p, _ in leaves_with_paths(p_params)]
    assert got == want
    assert "['segments'][0]['ln1']['scale']" in got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shape_divides_by_the_spec_axes(arch, mesh):
    _, _, _, p_params, p_opt, p_cache = trees(arch)
    m = MESHES[mesh]
    for tree, specs in ((p_params, port.param_pspecs(p_params, m)),
                        (p_opt, port.opt_pspecs(p_opt, port.param_pspecs(
                            p_params, m, "tp_only"), m)),
                        (p_cache, port.cache_pspecs(p_cache, m,
                                                    CACHE_BATCH, "seq"))):
        flat = [s for _, s in leaves_with_paths(specs, (), port.is_spec)]
        total = 0
        for (_, leaf), spec in zip(leaves_with_paths(tree), flat):
            want = [d // math.prod(m.shape[a] for a in port.spec_axes(e))
                    for d, e in zip(leaf.shape, tuple(spec)
                                    + (None,) * leaf.ndim)]
            got = port.local_shape(leaf.shape, spec, m)
            assert list(got) == want
            total += math.prod(want) * leaf.element_size()
        assert port.shard_bytes(tree, specs, m) == total


def test_check_spec_refuses_what_the_rules_never_make():
    m = SINGLE
    with pytest.raises(ValueError, match="twice"):
        port.check_spec(P("data", "data"), (32, 32), m)
    with pytest.raises(ValueError, match="divide"):
        port.check_spec(P("model", None), (24, 32), m)
    with pytest.raises(ValueError, match="no mesh axis"):
        port.check_spec(P("pod", None), (32, 32), m)
    assert port.local_shape((512, 48), P(("data", "model"), None),
                            MULTI) == (2, 48)


# ---------------------------------------------------------------------------
# the reference's tests/test_dist_sharding.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stablelm():
    return trees("stablelm_3b")[3]


def test_mesh_axes():
    assert port.mesh_axes(SINGLE) == ("data", "model")
    assert port.mesh_axes(MULTI) == (("pod", "data"), "model")


def test_rules_read_a_device_mesh_by_its_dim_names():
    """A ``DeviceMesh`` (``mesh_dim_names``, a ``shape`` tuple) is read as
    the duck-typed mesh of the same layout."""
    class DeviceMeshLike:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    m = DeviceMeshLike()
    assert port.mesh_axes(m) == (("pod", "data"), "model")
    assert port.batch_pspec(m, 64) == port.batch_pspec(MULTI, 64)
    assert port.local_shape((512, 48), P(("pod", "data"), "model"), m) == \
        (16, 3)


@pytest.mark.parametrize("mesh,batch,include_model,want", [
    (SINGLE, 64, False, P("data", None)),
    (SINGLE, 8, False, P(None, None)),
    (MULTI, 64, False, P(("pod", "data"), None)),
    (MULTI, 2, False, P("pod", None)),
    (SINGLE, 256, True, P(("data", "model"), None)),
])
def test_batch_pspec_divisibility(mesh, batch, include_model, want):
    assert port.batch_pspec(mesh, batch, include_model=include_model) == want


def test_param_pspecs_roles(stablelm):
    ps = port.param_pspecs(stablelm, SINGLE, policy="tp_only")
    seg0 = ps["segments"][0]
    # column-parallel: output dim; row-parallel: input dim; norms replicated
    assert seg0["attn"]["wq"][-1] == "model"
    assert seg0["attn"]["wo"][-2] == "model"
    assert seg0["ffn"]["up"][-1] == "model"
    assert seg0["ffn"]["down"][-2] == "model"
    assert all(d is None for d in seg0["ln1"]["scale"])


def test_param_pspecs_policies(stablelm):
    dp = port.param_pspecs(stablelm, SINGLE, policy="dp_only")
    assert all(all(d is None for d in p)
               for p in port_leaves(dp))
    fsdp = port.param_pspecs(stablelm, SINGLE, policy="fsdp")
    wq = fsdp["segments"][0]["attn"]["wq"]
    assert "model" in wq and any(d == "data" for d in wq)
    with pytest.raises(ValueError):
        port.param_pspecs(stablelm, SINGLE, policy="zigzag")


def port_leaves(tree):
    return [s for _, s in leaves_with_paths(tree, (), port.is_spec)]


def test_param_pspecs_respect_divisibility():
    # a dim not divisible by the axis size must stay unsharded
    params = {"wq": torch.empty((100, 30))}
    ps = port.param_pspecs(params, SINGLE, policy="tp_only")
    assert ps["wq"] == P(None, None)


def test_opt_pspecs_mirror_and_step(stablelm):
    p_ps = port.param_pspecs(stablelm, SINGLE, policy="fsdp")
    o_ps = port.opt_pspecs(opt_abstract(stablelm), p_ps)
    assert o_ps["step"] == P()
    assert (o_ps["m"]["segments"][0]["attn"]["wq"]
            == p_ps["segments"][0]["attn"]["wq"])


def test_cache_pspecs_modes():
    cache = cache_abstract(get_config("stablelm_3b"), 64, 4096)
    head = port.cache_pspecs(cache, SINGLE, 64, mode="head")
    seq = port.cache_pspecs(cache, SINGLE, 64, mode="seq")
    k_head = head["segments"][0]["k"]          # (L, b, s, kv_heads, dh)
    k_seq = seq["segments"][0]["k"]
    assert k_head[1] == "data"
    assert k_seq[2] == "model" and ("model" not in tuple(k_head)[2:3])
    with pytest.raises(ValueError):
        port.cache_pspecs(cache, SINGLE, 64, mode="paged")
