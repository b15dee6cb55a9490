"""The port's MoE FFN against the reference's: ``align_block_size``, the
grouped-FFN plain version (what the kernel wrapper runs for CPU tensors)
against the reference ``grouped_ffn`` (its Pallas kernel in interpret
mode, as the reference's own tests run it) and its oracle
``grouped_ffn_ref``, the routing helpers, and ``moe_ffn`` with and without
the kernel flag under router, balanced and skewed routing.

Inputs are float32 and made with numpy, so the point is the algorithm:
both sides sum the same products in other orders, which float32 rounding
bounds well inside 1e-4 (observed ~1e-6 at d <= 256, f <= 1024)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.arch import FFNSpec as RefFFNSpec  # noqa: E402
from repro.kernels.moe_ffn import ops as ref_ops  # noqa: E402
from repro.kernels.moe_ffn.kernel import moe_ffn_pallas  # noqa: E402
from repro.kernels.moe_ffn.ref import grouped_ffn_ref as ref_oracle  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.core.arch import FFNSpec  # noqa: E402
from repro_torch.kernels.moe_ffn import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's MOE_CASES (tests/test_kernels.py): (m, d, f, E, act)
MOE_CASES = [
    (8, 64, 32, 4, "swiglu"),
    (33, 128, 256, 8, "swiglu"),
    (64, 64, 512, 4, "gelu"),
    (100, 256, 1024, 16, "swiglu"),
    (1, 32, 64, 8, "swiglu"),
]


def _t(a):
    return torch.as_tensor(np.array(a))


def _expert_params(rng, e, d, f):
    return {name: (rng.standard_normal(shape) / np.sqrt(shape[1])
                   ).astype(np.float32)
            for name, shape in (("w_up", (e, d, f)), ("w_gate", (e, d, f)),
                                ("w_down", (e, f, d)))}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# align_block_size
# ---------------------------------------------------------------------------

ALIGN_CASES = [
    ([1, 0, 17, 16, 3, 0, 0, 31], 16),     # the reference's staircase case
    ([1, 0, 17, 16, 3, 0, 0, 31], 64),
    ([0, 0, 0, 5], 16),                    # one busy expert, last
    ([32] + [0] * 39, 16),                 # skewed: all rows on expert 0
    ([1] * 32 + [0] * 8, 16),              # granite decode, balanced
]


@pytest.mark.parametrize("gs,tb", ALIGN_CASES)
def test_align_block_size_equals_reference(gs, tb):
    gs = np.asarray(gs, np.int32)
    e, m = len(gs), int(gs.sum())
    expert_of = np.repeat(np.arange(e, dtype=np.int32), gs)
    want = ref_ops.align_block_size(jnp.asarray(expert_of), jnp.asarray(gs),
                                    e, tb)
    got = ops.align_block_size(_t(expert_of), _t(gs), e, tb)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # executed blocks = sum ceil(counts / tb): the M_moe staircase (Eq. 28)
    assert int(got[2].sum()) == sum(-(-int(c) // tb) for c in gs)
    assert len(set(got[0].tolist())) == m and int(got[0].max()) < got[3]


# ---------------------------------------------------------------------------
# grouped FFN: the plain version against the reference kernel and oracle
# ---------------------------------------------------------------------------

def _grouped_case(case, skew=False):
    m, d, f, e, act = case
    rng = np.random.default_rng(m)
    params = _expert_params(rng, e, d, f)
    if skew:
        gs = np.zeros(e, np.int32)
        gs[:2] = [m // 2, m - m // 2]
    else:
        gs = rng.multinomial(m, np.ones(e) / e).astype(np.int32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    return params, gs, x, act


@pytest.mark.parametrize("skew", [False, True], ids=["multinomial", "skewed"])
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_grouped_ffn_matches_reference(case, skew):
    params, gs, x, act = _grouped_case(case, skew)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    got = ops.grouped_ffn(_t(x), {k: _t(v) for k, v in params.items()},
                          _t(gs), act)
    kernel = ref_ops.grouped_ffn(jnp.asarray(x), jp, jnp.asarray(gs), act,
                                 interpret=True)
    _close(got, kernel)
    _close(got, ref_oracle(jnp.asarray(x), jp, jnp.asarray(gs), act))


@pytest.mark.parametrize("tb", [16, 64])
def test_padded_plain_version_matches_pallas_kernel(tb):
    """On the same padded layout and block metadata, the plain version
    equals the Pallas kernel block for block (invalid blocks: zeros)."""
    params, gs, x, act = _grouped_case((40, 64, 128, 8, "swiglu"))
    e = len(gs)
    expert_of = np.repeat(np.arange(e, dtype=np.int32), gs)
    slot, be, bv, m_pad = ops.align_block_size(_t(expert_of), _t(gs), e, tb)
    x_pad = np.zeros((m_pad, x.shape[1]), np.float32)
    x_pad[slot.numpy()] = x
    want = moe_ffn_pallas(jnp.asarray(x_pad), *(jnp.asarray(params[k]) for k in
                                                ("w_gate", "w_up", "w_down")),
                          jnp.asarray(be.numpy()), jnp.asarray(bv.numpy()),
                          token_block=tb, f_tile=128, activation=act,
                          interpret=True)
    got = ops.grouped_ffn_padded(_t(x_pad), *(_t(params[k]) for k in
                                              ("w_gate", "w_up", "w_down")),
                                 be, bv, token_block=tb, activation=act)
    _close(got, want)


def test_token_block_keys_on_token_count():
    """T <= E picks the 16-row block, T > E the 64-row one (the tau
    branch), whatever M = T*k is: the same rows through either block
    equal the reference forced to that block."""
    params, gs, x, act = _grouped_case((64, 32, 64, 8, "swiglu"))
    pt = {k: _t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for n_tokens, tb in ((8, 16), (9, 64)):
        want = ref_ops.grouped_ffn(jnp.asarray(x), jp, jnp.asarray(gs), act,
                                   token_block_override=tb, interpret=True)
        _close(ops.grouped_ffn(_t(x), pt, _t(gs), act, n_tokens=n_tokens),
               want)


@pytest.mark.parametrize("f", [768, 1000])
def test_f_tile_refusal(f):
    """f > 512 and no multiple of 512: the reference would drop the tail
    columns; the port raises, in the wrapper and in the plain version."""
    rng = np.random.default_rng(0)
    params = {k: _t(v) for k, v in _expert_params(rng, 2, 16, f).items()}
    x = _t(rng.standard_normal((4, 16)).astype(np.float32))
    gs = _t(np.array([2, 2], np.int32))
    with pytest.raises(ValueError, match="multiple of 512"):
        ops.grouped_ffn(x, params, gs, "swiglu")
    be = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 512"):
        ops.grouped_ffn_ref(torch.zeros(16, 16), params["w_gate"],
                            params["w_up"], params["w_down"], be, be + 1,
                            token_block=16, activation="swiglu")


def test_wrapper_refuses_bad_arguments():
    rng = np.random.default_rng(1)
    p = {k: _t(v) for k, v in _expert_params(rng, 2, 16, 32).items()}
    be = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="activation"):
        ops.grouped_ffn_padded(torch.zeros(16, 16), None, p["w_up"],
                               p["w_down"], be, be, token_block=16,
                               activation="relu")
    with pytest.raises(ValueError, match="w_gate"):
        ops.grouped_ffn_padded(torch.zeros(16, 16), None, p["w_up"],
                               p["w_down"], be, be, token_block=16,
                               activation="swiglu")


# ---------------------------------------------------------------------------
# routing and moe_ffn
# ---------------------------------------------------------------------------

def test_controlled_routing_patterns_equal_reference():
    for fn, ref in ((moe.balanced_routing, ref_moe.balanced_routing),
                    (moe.skewed_routing, ref_moe.skewed_routing)):
        for t, k, e in ((4, 8, 40), (41, 8, 40), (7, 2, 8)):
            np.testing.assert_array_equal(fn(t, k, e).numpy(),
                                          np.asarray(ref(t, k, e)))


def test_route_topk_matches_reference():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((64, 40)) * 0.02).astype(np.float32)
    x = rng.standard_normal((33, 64)).astype(np.float32)
    got = moe.route_topk(_t(w), _t(x), 8)
    want = ref_moe.route_topk(jnp.asarray(w), jnp.asarray(x), 8)
    _close(got[0], want[0], atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], atol=1e-6, rtol=1e-5)


MOE_SPECS = {
    "granite_reduced": dict(d_ff=32, activation="swiglu", n_experts=8,
                            top_k=2),
    "granite_width": dict(d_ff=64, activation="swiglu", n_experts=40,
                          top_k=8),
    "gelu_shared": dict(d_ff=48, activation="gelu", n_experts=6, top_k=2,
                        n_shared_experts=1),
}


# one compile per case instead of one per eager op
_ref_moe_ffn = jax.jit(ref_moe.moe_ffn, static_argnames=("f", "use_kernel"))


def _moe_case(spec, routing, t):
    """Inputs of one moe_ffn case and the reference's outputs with its
    kernel flag off and on."""
    kw = MOE_SPECS[spec]
    d, e, dff = 64, kw["n_experts"], kw["d_ff"]
    rng = np.random.default_rng(t)
    params = {"router": (rng.standard_normal((d, e)) * 0.02
                         ).astype(np.float32),
              **_expert_params(rng, e, d, dff)}
    if kw["activation"] != "swiglu":
        del params["w_gate"]
    if kw.get("n_shared_experts"):
        params["shared_up"] = (rng.standard_normal((d, dff)) / 8
                               ).astype(np.float32)
        params["shared_down"] = (rng.standard_normal((dff, d)) / 8
                                 ).astype(np.float32)
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    override = None
    if routing != "router":
        fn = ref_moe.balanced_routing if routing == "balanced" else \
            ref_moe.skewed_routing
        override = (np.asarray(fn(t, kw["top_k"], e)),
                    rng.random((t, kw["top_k"])).astype(np.float32))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_override = (None if override is None
                    else tuple(jnp.asarray(a) for a in override))
    want = [_ref_moe_ffn(jp, RefFFNSpec(kind="moe", **kw), jnp.asarray(x),
                         routing_override=ref_override, use_kernel=ref_kernel)
            for ref_kernel in (False, True)]
    return params, x, override, want


@pytest.fixture(scope="module")
def moe_cases():
    memo = {}

    def get(*key):
        if key not in memo:
            memo[key] = _moe_case(*key)
        return memo[key]
    return get


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("routing", ["router", "balanced", "skewed"])
@pytest.mark.parametrize("spec", sorted(MOE_SPECS))
@pytest.mark.parametrize("t", [5, 41])
def test_moe_ffn_matches_reference(moe_cases, spec, routing, use_kernel, t):
    """Against the reference with its kernel flag off (ragged_dot) and on
    (the Pallas kernel, interpret mode on the CPU)."""
    params, x, override, want = moe_cases(spec, routing, t)
    got, aux = moe.moe_ffn(
        {k: _t(v) for k, v in params.items()},
        FFNSpec(kind="moe", **MOE_SPECS[spec]), _t(x),
        routing_override=(None if override is None
                          else tuple(_t(a) for a in override)),
        use_kernel=use_kernel)
    assert got.shape == x.shape
    for out, out_aux in want:
        _close(got, out)
        _close(aux, out_aux, atol=1e-6, rtol=1e-5)


def test_init_moe_scales_follow_reference():
    """Expert leaves at 1/sqrt(E) (the reference ``_init``'s shape[0]
    default on (E, d, f)), the router f32 at 0.02."""
    f = FFNSpec(kind="moe", d_ff=256, activation="swiglu", n_experts=40,
                top_k=8)
    p = moe.init_moe(torch.Generator().manual_seed(0), 512, f,
                     lead=(2,))
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (2, 512, 40)
    np.testing.assert_allclose(float(p["router"].std()), 0.02, rtol=0.05)
    for key in ("w_up", "w_gate", "w_down"):
        assert p[key].dtype == torch.bfloat16
        np.testing.assert_allclose(float(p[key].float().std()), 40 ** -0.5,
                                   rtol=0.02)
