"""``loss_fn`` and every gradient leaf of the port against the
reference's ``jax.value_and_grad(loss_fn)`` for eight reduced models —
dense, MoE (granite, mixtral: aux_weight 0.01, so the aux gradient
counts), Mamba1, the Mamba2 hybrid, MLA, a VLM through ``embeds`` and
the encoder-decoder through ``frames`` — under remat False, True and 0.5,
and where remat checkpoints.

Weights are float32 (the reference's ``init_model`` through
``params_from_jax``).  Loss and gradients are held normwise within 1e-5
per leaf (observed <= 6e-6: float32 sums in another order through two or
three layers).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.training import loss_fn as ref_loss_fn  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.tree import (leaves, leaves_with_paths,  # noqa: E402
                                   path_key)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.training import loss_fn  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402

GRAD_TOL = 1e-5
GRAD_ARCHS = ["stablelm_3b", "granite_moe_3b_a800m", "falcon_mamba_7b",
              "zamba2_1p2b", "minicpm3_4b", "mixtral_8x22b",
              "phi3_vision_4p2b", "whisper_tiny"]


def _ref_flat(tree) -> dict:
    """The reference tree's leaves by the port's key of their path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        out[path_key(keys)] = np.asarray(leaf, np.float32)
    return out


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _model(arch):
    cfg = get_config(arch, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, port_config(arch, reduced=True), params, _port(params)


def _batch(cfg, arch, b=2, s=12, seed=0):
    """Tokens, plus the stub frontend's embeddings (phi3_vision) or frames
    (whisper), drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if arch == "phi3_vision_4p2b":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)
                                              ).astype(np.float32)
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=GRAD_ARCHS)
def grad_case(request):
    """The reference's loss and gradients (remat False, aux_weight 0.01:
    granite's and mixtral's MoE aux gradient counts) on a (2, 12) batch."""
    arch = request.param
    cfg, pcfg, params, port = _model(arch)
    batch = _batch(cfg, arch)
    (loss, metrics), grads = jax.value_and_grad(ref_loss_fn, has_aux=True)(
        params, cfg, _jax(batch), 0.01, False)
    return arch, pcfg, port, batch, float(loss), metrics, _ref_flat(grads)


@pytest.mark.parametrize("remat", [False, True, 0.5], ids=str)
def test_loss_and_every_gradient_leaf(grad_case, remat):
    """The port's value and every gradient leaf against the reference's
    ``jax.value_and_grad(loss_fn)``, normwise within GRAD_TOL; remat True
    and 0.5 recompute layers and must give the same gradients."""
    arch, pcfg, port, batch, loss, metrics, ref_grads = grad_case
    (got, pm), grads = value_and_grad(loss_fn, port, pcfg, _torch(batch),
                                      0.01, remat)
    assert float(got) == pytest.approx(loss, rel=GRAD_TOL)
    assert float(pm["ce"]) == pytest.approx(float(metrics["ce"]),
                                            rel=GRAD_TOL)
    assert float(pm["moe_aux"]) == pytest.approx(
        float(metrics["moe_aux"]), rel=GRAD_TOL, abs=1e-7)
    seen = set()
    for path, g in leaves_with_paths(grads):
        key = path_key(path)
        seen.add(key)
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), ref_grads[key]) <= GRAD_TOL, key
    assert seen == set(ref_grads)
    if pcfg.ffn.kind == "moe":
        assert float(pm["moe_aux"]) > 0


def test_value_and_grad_leaves_params_untouched():
    """No ``.grad`` and no ``requires_grad`` stay on the params."""
    cfg, pcfg, _, port = _model("stablelm_3b")
    batch = _torch(_batch(cfg, "stablelm_3b"))
    value_and_grad(loss_fn, port, pcfg, batch, 0.0, True)
    for p in leaves(port):
        assert p.grad is None and not p.requires_grad


@pytest.mark.parametrize("remat,count,want",
                         [(False, 4, 0), (True, 4, 4), (0.5, 4, 2),
                          (0.5, 3, 2), (0.5, 5, 2), (0.25, 2, 0),
                          (0.75, 2, 2)])
def test_remat_count_rounds_half_to_even(remat, count, want):
    """round(frac * count) with Python's round: 1.5 -> 2, 2.5 -> 2, 0.5 ->
    0 (the reference's code, not its docstring's ceil)."""
    assert transformer.remat_count(remat, count) == want


@pytest.mark.parametrize("remat", [False, True, 0.5], ids=str)
def test_remat_checkpoints_the_leading_layers_of_each_segment(
        monkeypatch, remat):
    """zamba2 (an SSM segment, then hybrid layers) and whisper (encoder,
    whose layers are never recomputed, as in the reference): exactly
    remat_count layers per decoder segment go through checkpoint, and none
    with a cache."""
    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", counting)
    for arch in ("zamba2_1p2b", "whisper_tiny"):
        cfg, pcfg, _, port = _model(arch)
        calls.clear()
        loss_fn(port, pcfg, _torch(_batch(cfg, arch)), 0.0, remat)
        want = sum(transformer.remat_count(remat, n)
                   for _, n in transformer.make_segments(pcfg))
        assert len(calls) == want, (arch, calls)


def test_remat_is_off_with_a_cache(monkeypatch):
    monkeypatch.setattr(transformer, "checkpoint", None)   # would raise
    cfg, pcfg, _, port = _model("stablelm_3b")
    cache = transformer.init_cache(pcfg, 1, 16, torch.float32, "cpu")
    toks = torch.as_tensor(_batch(cfg, "stablelm_3b", b=1, s=5)["tokens"])
    transformer.forward(port, pcfg, {"tokens": toks}, mode="prefill",
                        cache=cache, remat=True)
