"""The plain MoE path as one grouped product per weight.

``moe_ffn(use_kernel=False)`` runs ``torch._grouped_mm`` over each
expert's own rows (``models.moe.grouped_products``).  For reduced
granite, mixtral and llada, in float32 with numpy-made inputs, under the
learned router and the skewed routing (which leaves experts without
rows), its output and the gradients of every leaf are held against the
reference's ``ragged_dot`` path (``jax.grad`` of the same loss) and
against ``masked_ffn``, a per-expert masked loop kept here: every row
through every expert, each keeping its own by ``torch.where``.
``FlopCounterMode`` counts the routed work exactly, in float32 and for a
bf16 call under ``FakeTensorMode``.  The block-aligned route that a CUDA
tensor of another type than bf16 takes is held against the grouped one.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

F = torch.nn.functional
ARCHS = ("granite_moe_3b_a800m", "mixtral_8x22b", "llada_mini_like")
T = 24
TOL = dict(atol=1e-4, rtol=1e-4)


def masked_ffn(x_sorted, params, group_sizes, activation, n_tokens=0):
    """Each sorted row through every expert's FFN, each row keeping its
    own expert's by ``torch.where``: O(M·E), products in x's type and
    ``h`` rounded to it."""
    m = x_sorted.shape[0]
    expert_of_row = torch.searchsorted(
        torch.cumsum(group_sizes, 0, dtype=torch.int32),
        torch.arange(m, dtype=torch.int32, device=x_sorted.device),
        right=True)
    out = torch.zeros_like(x_sorted)
    for ei in range(group_sizes.shape[0]):
        up = x_sorted @ params["w_up"][ei]
        if activation == "swiglu":
            gate = x_sorted @ params["w_gate"][ei]
            h = (F.silu(gate.float()) * up.float()).to(x_sorted.dtype)
        else:
            h = F.gelu(up.float(), approximate="tanh").to(x_sorted.dtype)
        out = torch.where((expert_of_row == ei)[:, None],
                          h @ params["w_down"][ei], out)
    return out


def _case(arch, routing):
    """(FFN spec, reference spec, numpy params, x (1, T, d), override or
    None, the output's cotangent)."""
    cfg = get_config(arch, reduced=True)
    f = cfg.ffn
    d, e, dff = cfg.d_model, f.n_experts, f.d_ff
    rng = np.random.default_rng(len(arch))
    params = {"router": (rng.standard_normal((d, e)) * 0.5
                         ).astype(np.float32)}
    for name, shape in (("w_up", (e, d, dff)), ("w_gate", (e, d, dff)),
                        ("w_down", (e, dff, d))):
        params[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])
                        ).astype(np.float32)
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    override = None
    if routing == "skewed":
        override = (np.asarray(ref_moe.skewed_routing(T, f.top_k, e)),
                    rng.random((T, f.top_k)).astype(np.float32))
    cot = rng.standard_normal((1, T, d)).astype(np.float32)
    return f, ref_config(arch, reduced=True).ffn, params, x, override, cot


def _port(f, params, x, override, cot, ffn=None, monkeypatch=None):
    """(out, aux, {leaf: grad}) of the port's plain path under loss
    sum(out·cot) + aux; ``ffn`` replaces ``moe.plain_ffn``."""
    if ffn is not None:
        monkeypatch.setattr(moe, "plain_ffn", ffn)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ov = None if override is None else tuple(torch.tensor(a)
                                             for a in override)
    out, aux = moe.moe_ffn(tp, f, tx, routing_override=ov)
    ((out * torch.tensor(cot)).sum() + aux).backward()
    # the router has no gradient under an override (the reference: zeros)
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
             for k, v in tp.items()}
    grads["x"] = tx.grad
    return out, aux, grads


@pytest.mark.parametrize("routing", ["router", "skewed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_path_matches_reference_and_masked_loop(arch, routing,
                                                        monkeypatch):
    f, ref_f, params, x, override, cot = _case(arch, routing)
    if routing == "skewed":
        counts = np.bincount(override[0].reshape(-1),
                             minlength=f.n_experts)
        assert (counts == 0).any()            # experts without rows
    out, aux, grads = _port(f, params, x, override, cot)

    jov = None if override is None else tuple(jnp.asarray(a)
                                              for a in override)

    def loss(p, xx):
        o, a = ref_moe.moe_ffn(p, ref_f, xx, routing_override=jov,
                               use_kernel=False)
        return jnp.sum(o * jnp.asarray(cot)) + a, (o, a)
    (_, (want, want_aux)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=1e-5)
    want_grads = {**{k: np.asarray(v) for k, v in g_p.items()},
                  "x": np.asarray(g_x)}
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name], **TOL,
                                   err_msg=name)

    m_out, m_aux, m_grads = _port(f, params, x, override, cot,
                                  ffn=masked_ffn, monkeypatch=monkeypatch)
    np.testing.assert_allclose(out.detach().numpy(), m_out.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), m_grads[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_sum_backward_reaches_every_leaf(arch):
    """``out.sum().backward()`` hands the products an expanded gradient;
    ``_grouped_mm``'s backward takes only a contiguous one."""
    f, _, params, x, _, _ = _case(arch, "router")
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    moe.moe_ffn(tp, f, tx)[0].sum().backward()
    masked = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
    mx = torch.tensor(x, requires_grad=True)
    real = moe.plain_ffn
    try:
        moe.plain_ffn = masked_ffn
        moe.moe_ffn(masked, f, mx)[0].sum().backward()
    finally:
        moe.plain_ffn = real
    for k in ("w_up", "w_gate", "w_down"):
        assert torch.isfinite(tp[k].grad).all()
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   masked[k].grad.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), mx.grad.numpy(), atol=1e-6,
                               rtol=1e-6)
    # the products' own output summed: its gradient reaches them expanded
    gs = torch.tensor([T, 0] + [T] * (f.n_experts - 2), dtype=torch.int32)
    xs = torch.tensor(np.resize(x[0], (int(gs.sum()), x.shape[-1])),
                      requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    moe.grouped_products(xs, tp, gs, f.activation).sum().backward()
    ms = xs.detach().clone().requires_grad_()
    mp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    masked_ffn(ms, mp, gs, f.activation).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), ms.grad.numpy(), atol=1e-5,
                               rtol=1e-5)
    for k in ("w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(tp[k].grad.numpy(), mp[k].grad.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _routed_flops(f, d, t, router: bool) -> int:
    """The forward's FLOPs: 2·M·d·f a product over the M = T·k routed rows
    (3 products for SwiGLU, 2 for GELU), the router's 2·T·d·E and the
    shared experts' 2 · 2·T·d·(n_shared·f)."""
    m = t * f.top_k
    n = 2 * m * d * f.d_ff * (3 if f.activation == "swiglu" else 2)
    if router:
        n += 2 * t * d * f.n_experts
    if f.n_shared_experts:
        n += 2 * 2 * t * d * f.n_shared_experts * f.d_ff
    return n


@pytest.mark.parametrize("routing", ["router", "skewed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flop_counter_counts_the_routed_work(arch, routing):
    """Forward: exactly the routed products; backward: two products of
    the same size for each (the input's and the weight's gradient)."""
    from torch.utils.flop_counter import FlopCounterMode
    f, _, params, x, override, _ = _case(arch, routing)
    d = x.shape[-1]
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ov = None if override is None else tuple(torch.tensor(a)
                                             for a in override)
    with FlopCounterMode(display=False) as fc:
        out, aux = moe.moe_ffn(tp, f, tx, routing_override=ov)
    want = _routed_flops(f, d, T, router=override is None)
    assert fc.get_total_flops() == want
    with FlopCounterMode(display=False) as fc:
        (out.sum() + aux).backward()
    assert fc.get_total_flops() == 2 * want


@pytest.mark.parametrize("arch", ARCHS)
def test_flop_counter_counts_the_routed_work_bf16_fake(arch):
    """The same count for bf16 fake tensors (the dry run's), forward and
    backward: ``_grouped_mm``'s meta function takes bf16 only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch, reduced=True)
    f, d = cfg.ffn, cfg.d_model
    with FakeTensorMode():
        params = moe.init_moe(torch.Generator().manual_seed(0), d, f)
        for v in params.values():
            v.requires_grad_()
        x = torch.empty((2, T // 2, d), dtype=torch.bfloat16,
                        requires_grad=True)
        with FlopCounterMode(display=False) as fc:
            out, aux = moe.moe_ffn(params, f, x)
        fwd = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            (out.float().sum() + aux).backward()
        bwd = fc.get_total_flops()
    want = _routed_flops(f, d, T, router=True)
    assert fwd == want and bwd == 2 * want


@pytest.mark.parametrize("routing", ["router", "skewed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_aligned_route_equals_the_grouped_products(arch, routing):
    """The block-aligned product (a CUDA tensor's route for types other
    than bf16) against the grouped one, output and gradients."""
    f, _, params, x, override, cot = _case(arch, routing)
    xt = torch.tensor(x[0])
    idx = (torch.tensor(override[0]) if override is not None else
           moe.route_topk(torch.tensor(params["router"]), xt, f.top_k)[1])
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    gs = torch.zeros(f.n_experts, dtype=torch.int32).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    got = {}
    for name in ("grouped", "aligned"):
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        xs = xt[order // f.top_k].clone().requires_grad_()
        if name == "grouped":
            y = moe.grouped_products(xs, tp, gs, f.activation)
        else:
            y = moe.aligned_products(xs, tp, gs, f.activation, T)
        (y * torch.tensor(cot[0])[order // f.top_k]).sum().backward()
        got[name] = (y, xs.grad, {k: tp[k].grad for k in
                                  ("w_up", "w_gate", "w_down")})
    (y0, gx0, g0), (y1, gx1, g1) = got["grouped"], got["aligned"]
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gx1.numpy(), gx0.numpy(), atol=1e-5,
                               rtol=1e-5)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_the_masked_loop_left_the_package():
    assert not hasattr(moe, "ragged_ffn")
    assert moe.plain_ffn.__module__ == "repro_torch.models.moe"
