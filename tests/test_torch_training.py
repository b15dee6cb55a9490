"""The port's training path against the reference's: ``layernorm`` and
``softmax_cross_entropy``, ``mtp_loss``, AdamW (the LR schedule, the
decayed leaves, one update on f32 and bf16 params), grad accumulation, a
five-step loss curve against the reference's jitted ``train_step``, and
the train launcher on the CPU.  ``loss_fn``'s gradients for eight models
are in ``test_torch_train_grads.py``.

Weights are float32 (the reference's ``init_model`` through
``params_from_jax``) so the point is the algorithm.  Tolerances, stated
per test: losses and gradients normwise 1e-5 (observed <= 6e-6: float32
sums in another order through two or three layers); Adam's update divides
by sqrt(v), so a parameter after k steps may differ by a rounding of an
element whose gradient is near zero, bounded by 1e-4 at a peak lr of
3e-3 (observed 2.7e-5).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import DataConfig, make_pipeline  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.layers import init_layernorm as ref_init_layernorm  # noqa: E402
from repro.models.layers import layernorm as ref_layernorm  # noqa: E402
from repro.models.layers import softmax_cross_entropy as ref_ce  # noqa: E402
from repro.serving import init_mtp_heads as ref_init_heads  # noqa: E402
from repro.serving import mtp_loss as ref_mtp_loss  # noqa: E402
from repro.training import AdamWConfig as RefAdamW  # noqa: E402
from repro.training import adamw_update as ref_adamw  # noqa: E402
from repro.training import grad_accum_fn as ref_grad_accum  # noqa: E402
from repro.training import init_opt_state as ref_init_opt  # noqa: E402
from repro.training import lr_schedule as ref_lr_schedule  # noqa: E402
from repro.training import make_train_step as ref_make_step  # noqa: E402
from repro.training.optimizer import _decay_mask as ref_decay_mask  # noqa: E402
from repro.training.train_step import compress_grads as ref_compress  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.tree import (leaves, leaves_with_paths,  # noqa: E402
                                   path_key, unflatten)
from repro_torch.launch.train import build_parser, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import (init_layernorm, layernorm,  # noqa: E402
                                       softmax_cross_entropy)
from repro_torch.serving import mtp_loss  # noqa: E402
from repro_torch.training import (AdamWConfig, adamw_update,  # noqa: E402
                                  grad_accum_fn, init_opt_state, loss_fn,
                                  lr_schedule, make_train_step)
from repro_torch.training.optimizer import _decay_mask  # noqa: E402
from repro_torch.training.train_step import (compress_grads,  # noqa: E402
                                             value_and_grad)

GRAD_TOL = 1e-5


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
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((2, 5, 16), "float32"),
                                         ((7, 24), "float32"),
                                         ((3, 4, 32), "bfloat16")])
def test_layernorm_matches_reference(shape, dtype):
    """f32 to 1e-6; bf16 within one bf16 ulp (both compute in f32 and
    round once at the end)."""
    rng = np.random.default_rng(1)
    d = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.standard_normal(d).astype(np.float32),
         "bias": rng.standard_normal(d).astype(np.float32)}
    jd = jnp.dtype(dtype)
    want = np.asarray(ref_layernorm(
        {k: jnp.asarray(v, jd) for k, v in p.items()},
        jnp.asarray(x, jd)), np.float32)
    td = getattr(torch, dtype)
    got = layernorm({k: torch.as_tensor(v).to(td) for k, v in p.items()},
                    torch.as_tensor(x).to(td))
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_init_layernorm_matches_reference():
    ref = ref_init_layernorm(24)
    got = init_layernorm(torch.Generator(), 24)
    assert set(got) == set(ref) == {"scale", "bias"}
    for k in ref:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))


@pytest.mark.parametrize("mask", [None, "float", "int", "zeros"])
def test_softmax_cross_entropy_matches_reference(mask):
    """Unmasked mean, a float and an int mask, and an all-zero mask (the
    masked mean's denominator clamped at 1): 1e-6."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = None
    if mask == "float":
        m = (rng.random((3, 7)) < 0.6).astype(np.float32)
    elif mask == "int":
        m = (rng.random((3, 7)) < 0.6).astype(np.int32)
    elif mask == "zeros":
        m = np.zeros((3, 7), np.float32)
    want = float(ref_ce(jnp.asarray(logits), jnp.asarray(labels),
                        None if m is None else jnp.asarray(m)))
    got = softmax_cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels),
                                None if m is None else torch.as_tensor(m))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_softmax_cross_entropy_of_bf16_logits_is_f32():
    logits = torch.randn(2, 3, 11, generator=torch.Generator().manual_seed(0)
                         ).to(torch.bfloat16)
    labels = torch.tensor([[0, 1, 2], [3, 4, 5]])
    got = softmax_cross_entropy(logits, labels)
    want = softmax_cross_entropy(logits.float(), labels)
    assert got.dtype == torch.float32 and float(got) == float(want)


@pytest.mark.parametrize("seq", [16, 3, 2])
def test_mtp_loss_value_and_grad(seq):
    """Head h predicts offset h + 2 (seq 3: only the first of three heads
    fits; seq 2: none, loss 0): value 1e-6, gradients normwise 1e-5."""
    d, v = 32, 64
    heads = jax.tree.map(np.asarray, ref_init_heads(
        jax.random.PRNGKey(0), d, v, 3, dtype=jnp.float32))
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, seq, d)).astype(np.float32)
    tokens = rng.integers(0, v, (2, seq)).astype(np.int32)
    want, (gh, gx) = jax.value_and_grad(ref_mtp_loss, argnums=(0, 1))(
        {"heads": jnp.asarray(heads["heads"])}, jnp.asarray(hidden),
        jnp.asarray(tokens))
    th = torch.as_tensor(heads["heads"]).requires_grad_()
    tx = torch.as_tensor(hidden).requires_grad_()
    got = mtp_loss({"heads": th}, tx, torch.as_tensor(tokens))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    if seq <= 2:
        assert float(got) == 0.0
        return
    gth, gtx = torch.autograd.grad(got, (th, tx))
    assert _rel(gth.numpy(), np.asarray(gh["heads"])) <= GRAD_TOL
    assert _rel(gtx.numpy(), np.asarray(gx)) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    """Warmup, peak, cosine decay and floor over steps 0..110, as numbers
    and as an int32 tensor: 1e-6 relative; the reference's shape test."""
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    cfg, rcfg = AdamWConfig(**kw), RefAdamW(**kw)
    lrs = []
    for s in range(111):
        want = float(ref_lr_schedule(rcfg, jnp.asarray(s)))
        got = float(lr_schedule(cfg, s))
        t = float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
        assert t == got
        lrs.append(got)
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] == pytest.approx(1e-4, rel=1e-3)
    assert all(lrs[i] >= lrs[i + 1] - 1e-12 for i in range(10, 110))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decayed_leaves_match_reference(arch):
    """The set of weight-decayed leaves equals the reference's for every
    model of the zoo (norms, biases, A_log / A_logh, D, dt_bias exempt)."""
    cfg = get_config(arch, reduced=True)
    params = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg))
    want = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        if ref_decay_mask(path):
            want.add(path_key(keys))
    port = transformer.init_model(port_config(arch, reduced=True),
                                  torch.Generator(), "cpu", torch.float32)
    got = {path_key(p) for p, _ in leaves_with_paths(port)
           if _decay_mask(path_key(p))}
    assert got == want
    assert len({path_key(p) for p, _ in leaves_with_paths(port)}) > len(got)


def _update_case(dtype):
    """Reduced stablelm params in ``dtype``, an opt state at step 3 with
    random moments, and random grads whose norm clips at 1.0."""
    cfg = get_config("stablelm_3b", reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(4)

    def draw(p, scale=1.0):
        return jnp.asarray(rng.standard_normal(p.shape) * scale, jnp.float32)
    opt = ref_init_opt(params)
    opt = {"master": jax.tree.map(lambda m: m + draw(m, 1e-3),
                                  opt["master"]),
           "m": jax.tree.map(lambda m: draw(m, 1e-2), opt["m"]),
           "v": jax.tree.map(lambda m: jnp.abs(draw(m, 1e-4)), opt["v"]),
           "step": jnp.asarray(3, jnp.int32)}
    grads = jax.tree.map(lambda p: draw(p, 0.05).astype(p.dtype), params)
    return params, opt, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One update with clipping (the grads' norm is > 1) and weight decay
    (warmup done, lr 1e-3): the norm within 1e-5 (a float32 sum of ~1e5
    squares in another order; observed 1.6e-6); master, m and v within
    1e-5 of each leaf's largest magnitude (the clip factor carries the
    norm's error, and b1·m + (1-b1)·g may cancel), the new params in f32
    the same, in bf16 within one bf16 ulp of the reference's (both round
    the master once)."""
    from repro_torch.bridge import opt_state_from_jax
    params, opt, grads = _update_case(dtype)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    rp, ro, rm = ref_adamw(RefAdamW(**kw), params, grads, opt)
    port = _port(params)
    popt = opt_state_from_jax(jax.tree.map(np.asarray, opt))
    pp, po, pm = adamw_update(AdamWConfig(**kw), port, _port(grads), popt)
    assert float(rm["grad_norm"]) > 1.0
    assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-5)
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(po["step"]) == int(ro["step"]) == 4
    for key in ("master", "m", "v"):
        want = _ref_flat(ro[key])
        for path, t in leaves_with_paths(po[key]):
            w = want[path_key(path)]
            np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    want = _ref_flat(rp)
    for path, t in leaves_with_paths(pp):
        assert t.dtype == getattr(torch, dtype)
        w = want[path_key(path)]
        tol = (np.abs(w) * 2.0 ** -8 if dtype == "bfloat16"
               else 1e-5 * np.abs(w).max())
        assert np.all(np.abs(t.float().numpy() - w) <= tol), path


def test_adamw_update_is_in_place_and_keeps_dtypes():
    """The params and state tensors given are the ones updated (no second
    tree); an f32 leaf (the MoE router) stays f32 among bf16 weights; the
    grads are only read."""
    cfg = port_config("granite_moe_3b_a800m", reduced=True)
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    opt = init_opt_state(params)
    grads = [torch.ones_like(p) for p in leaves(params)]
    before = [g.clone() for g in grads]
    ids = [id(t) for t in leaves(params) + leaves(opt)]
    dtypes = [p.dtype for p in leaves(params)]
    new_p, new_o, _ = adamw_update(AdamWConfig(warmup_steps=0), params,
                                   unflatten(params, grads), opt)
    assert [id(t) for t in leaves(new_p) + leaves(new_o)] == ids
    assert [p.dtype for p in leaves(new_p)] == dtypes
    assert torch.float32 in dtypes and torch.bfloat16 in dtypes
    assert all(torch.equal(g, b) for g, b in zip(grads, before))
    assert int(new_o["step"]) == 1
    assert new_o["master"] is not params


def test_init_opt_state_never_aliases_params():
    params = {"w": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
    opt = init_opt_state(params)
    assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert opt["master"]["b"].dtype == torch.float32
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


# ---------------------------------------------------------------------------
# grad accumulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def accum_case():
    cfg, pcfg, params, port = _model("stablelm_3b")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 16)
                                             ).astype(np.int32)
    return cfg, pcfg, params, port, toks


def test_grad_accum_matches_full_batch_and_reference(accum_case):
    """n_micro 4 against the full batch (the mean of the micro-batch
    means is the batch mean: normwise 1e-5) and against the reference's
    grad_accum_fn (normwise 1e-5; loss and CE 1e-6)."""
    cfg, pcfg, params, port, toks = accum_case
    rg, rl, rce = ref_grad_accum(params, cfg, {"tokens": jnp.asarray(toks)},
                                 n_micro=4, aux_weight=0.0, remat=False)
    g, loss, ce = grad_accum_fn(port, pcfg, {"tokens": torch.as_tensor(toks)},
                                n_micro=4, aux_weight=0.0, remat=True)
    (full, _), gfull = value_and_grad(loss_fn, port, pcfg,
                                      {"tokens": torch.as_tensor(toks)},
                                      0.0, False)
    assert float(loss) == pytest.approx(float(rl), rel=1e-6)
    assert float(ce) == pytest.approx(float(rce), rel=1e-6)
    assert float(loss) == pytest.approx(float(full), rel=1e-6)
    want = _ref_flat(rg)
    for (path, a), b in zip(leaves_with_paths(g), leaves(gfull)):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), want[path_key(path)]) <= GRAD_TOL
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL


def test_grad_accum_takes_a_pre_split_batch(accum_case):
    """(n_micro, mb, s) gives the flat batch's result bitwise."""
    _, pcfg, _, port, toks = accum_case
    flat = grad_accum_fn(port, pcfg, {"tokens": torch.as_tensor(toks)}, 2,
                         0.0, False)
    split = grad_accum_fn(port, pcfg,
                          {"tokens": torch.as_tensor(toks).reshape(2, 4, 16)},
                          2, 0.0, False)
    assert torch.equal(flat[1], split[1]) and torch.equal(flat[2], split[2])
    for a, b in zip(leaves(flat[0]), leaves(split[0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tokens_shape,n_micro,match",
                         [((3, 4, 16), 2, "pre-split batch has 3"),
                          ((6, 16), 4, "not divisible by n_micro=4")])
def test_grad_accum_raises_as_the_reference(accum_case, tokens_shape,
                                            n_micro, match):
    cfg, pcfg, params, port, _ = accum_case
    toks = np.zeros(tokens_shape, np.int32)
    with pytest.raises(ValueError, match=match):
        ref_grad_accum(params, cfg, {"tokens": jnp.asarray(toks)}, n_micro)
    with pytest.raises(ValueError, match=match):
        grad_accum_fn(port, pcfg, {"tokens": torch.as_tensor(toks)}, n_micro)


@pytest.mark.parametrize("enabled", [False, True])
def test_compress_grads_matches_reference(enabled):
    """The bf16 round trip's values, bitwise; disabled returns the tree."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    want = _ref_flat(ref_compress(jax.tree.map(jnp.asarray, tree), enabled))
    port = _port(tree)
    got = compress_grads(port, enabled)
    if not enabled:
        assert got is port
    for path, t in leaves_with_paths(got):
        np.testing.assert_array_equal(t.float().numpy(), want[path_key(path)])


def test_compressed_accumulation_matches_reference(accum_case):
    """grad_accum_fn(compress=True): each micro-batch's grads rounded to
    bf16 before the f32 accumulation, as the reference's (normwise 1e-3:
    a bf16 rounding may fall either side between the stacks)."""
    cfg, pcfg, params, port, toks = accum_case
    rg, _, _ = ref_grad_accum(params, cfg, {"tokens": jnp.asarray(toks)},
                              n_micro=2, aux_weight=0.0, remat=False,
                              compress=True)
    g, _, _ = grad_accum_fn(port, pcfg, {"tokens": torch.as_tensor(toks)},
                            n_micro=2, aux_weight=0.0, remat=False,
                            compress=True)
    g32, _, _ = grad_accum_fn(port, pcfg, {"tokens": torch.as_tensor(toks)},
                              n_micro=2, aux_weight=0.0, remat=False)
    want = _ref_flat(rg)
    changed = 0
    for (path, a), b in zip(leaves_with_paths(g), leaves(g32)):
        assert _rel(a.numpy(), want[path_key(path)]) <= 1e-3
        changed += not torch.equal(a, b)
    assert changed


# ---------------------------------------------------------------------------
# the loss curve against the reference's jitted train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm_3b", "granite_moe_3b_a800m"])
def test_five_step_loss_curve_matches_reference(arch):
    """5 train_steps (n_micro 2, remat True, clip 0.25 active every step,
    peak lr 3e-3) on the same SyntheticLM batches as the reference's
    jitted train_step: loss, ce, grad_norm 1e-5 and lr 1e-6 per step;
    params and master within 1e-4, m 1e-6, v 1e-8 after the last."""
    cfg, pcfg, params, port = _model(arch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5, clip_norm=0.25)
    rstep = jax.jit(ref_make_step(cfg, RefAdamW(**kw), n_micro=2,
                                  remat=True))
    pstep = make_train_step(pcfg, AdamWConfig(**kw), n_micro=2, remat=True)
    ropt, popt = ref_init_opt(params), init_opt_state(port)
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4))
    for _ in range(5):
        toks = next(data)["tokens"]
        params, ropt, rm = rstep(params, ropt, {"tokens": jnp.asarray(toks)})
        port, popt, pm = pstep(port, popt, {"tokens": torch.as_tensor(toks)})
        for k in ("loss", "ce", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(pm["grad_norm"]) > 0.25
    assert int(popt["step"]) == int(ropt["step"]) == 5
    for got, want, atol in ((port, params, 1e-4),
                            (popt["master"], ropt["master"], 1e-4),
                            (popt["m"], ropt["m"], 1e-6),
                            (popt["v"], ropt["v"], 1e-8)):
        ref = _ref_flat(want)
        for path, t in leaves_with_paths(got):
            np.testing.assert_allclose(t.numpy(), ref[path_key(path)],
                                       rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """--device cpu --tiny --steps 12 --ckpt-every 5: the loss falls and
    checkpoints 5, 10 and 12 hold as many optimizer steps as their label;
    a second run on the directory resumes at 12 and runs no step."""
    from repro_torch.checkpoint import latest_step, restore
    argv = ["--device", "cpu", "--tiny", "--steps", "12", "--ckpt-every",
            "5", "--ckpt-dir", str(tmp_path)]
    out = train(build_parser().parse_args(argv))
    assert out["start"] == 0 and len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000005", "step_0000000010", "step_0000000012"]
    for step in (5, 10, 12):
        tree, meta = restore(str(tmp_path), out["state"], step=step)
        assert meta == {"step": step} and int(tree["opt"]["step"]) == step
    assert "training complete; checkpoint committed" in capsys.readouterr().out
    again = train(build_parser().parse_args(argv))
    assert "resumed at step 12" in capsys.readouterr().out
    assert again["start"] == 12 and again["losses"] == []
    assert latest_step(str(tmp_path)) == 12
    for a, b in zip(leaves(again["state"]), leaves(out["state"])):
        assert torch.equal(a, b)


def test_train_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(build_parser().parse_args(["--tiny", "--steps", "1",
                                         "--ckpt-dir", str(tmp_path)]))


# ---------------------------------------------------------------------------
# the launcher's recovery: resume and rollback in float32, bitwise
# ---------------------------------------------------------------------------

RECOVERY_ARGV = ["--device", "cpu", "--tiny", "--steps", "10",
                 "--ckpt-every", "5", "--seq", "16", "--global-batch", "4"]


def _f32_launcher(mp):
    """The train launcher with float32 weights (it draws bf16 ones)."""
    import repro_torch.launch.train as launcher
    real = launcher.init_model
    mp.setattr(launcher, "init_model",
               lambda cfg, gen, device: real(cfg, gen, device,
                                             torch.float32))
    return launcher


def _run(ckpt_dir):
    return train(build_parser().parse_args(RECOVERY_ARGV
                                           + ["--ckpt-dir", str(ckpt_dir)]))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Tiny stablelm_3b, float32, 10 steps, a checkpoint every 5."""
    ckpt_dir = tmp_path_factory.mktemp("uninterrupted")
    with pytest.MonkeyPatch.context() as mp:
        _f32_launcher(mp)
        out = _run(ckpt_dir)
    assert out["start"] == 0 and len(out["losses"]) == 10
    return ckpt_dir, out


@pytest.fixture
def f32_launcher(monkeypatch):
    return _f32_launcher(monkeypatch)


def _assert_bitwise(got, want):
    for (path, a), b in zip(leaves_with_paths(got), leaves(want)):
        assert a.dtype == b.dtype == torch.float32 or a.dtype == b.dtype
        assert torch.equal(a, b), path_key(path)


def test_train_cli_resume_is_bitwise_the_uninterrupted_run(
        uninterrupted, f32_launcher, tmp_path, capsys):
    """``step_0000000010`` deleted, the run again resumes at 5 on batches
    5-9 (the stream advanced by the restored step), so its losses and its
    final params and AdamW state are bitwise the uninterrupted run's."""
    import shutil
    src, want = uninterrupted
    shutil.copytree(src, tmp_path / "ck")
    shutil.rmtree(tmp_path / "ck" / "step_0000000010")
    got = _run(tmp_path / "ck")
    assert "resumed at step 5" in capsys.readouterr().out
    assert got["start"] == 5
    assert got["losses"] == want["losses"][5:]
    _assert_bitwise(got["state"], want["state"])


def test_train_cli_rolls_back_a_failure_mid_update(uninterrupted,
                                                   f32_launcher, tmp_path,
                                                   monkeypatch, capsys):
    """One failure inside step 7's AdamW update, at its second leaf (the
    first leaf, its m / v and ``step`` already written in place): the run
    rolls back to checkpoint 5 rather than retrying the step on top of
    the half-applied update, rebuilds the stream at batch 5, and ends
    bitwise equal to the uninterrupted run."""
    from repro_torch.training import optimizer
    _, want = uninterrupted
    n_leaves = len(leaves(want["state"]["params"]))
    real, calls = optimizer._decay_mask, []

    def failing_mask(key):
        calls.append(key)
        if len(calls) == 7 * n_leaves + 2:
            raise RuntimeError("injected failure mid-update")
        return real(key)
    monkeypatch.setattr(optimizer, "_decay_mask", failing_mask)
    got = _run(tmp_path)
    assert "rolled back to step 5" in capsys.readouterr().out
    # 7 updates and two leaves, then steps 5-9 again
    assert len(calls) == 7 * n_leaves + 2 + 5 * n_leaves
    assert got["losses"] == want["losses"]
    _assert_bitwise(got["state"], want["state"])


def test_train_cli_retries_a_batch_fetch_in_place(uninterrupted,
                                                  f32_launcher, tmp_path,
                                                  monkeypatch, capsys):
    """A failure while step 3's batch is fetched (before the update
    begins) is retried in place, with no rollback: the run ends bitwise
    equal to the uninterrupted one."""
    _, want = uninterrupted
    real, fetches = f32_launcher.make_pipeline, []

    class Flaky:
        def __init__(self, stream):
            self.stream = stream

        def __next__(self):
            fetches.append(1)
            if len(fetches) == 4:
                raise OSError("injected flaky read")
            return next(self.stream)

    monkeypatch.setattr(f32_launcher, "make_pipeline",
                        lambda cfg, start=0: Flaky(real(cfg, start=start)))
    got = _run(tmp_path)
    assert "rolled back" not in capsys.readouterr().out
    assert len(fetches) == 11
    assert got["losses"] == want["losses"]
    _assert_bitwise(got["state"], want["state"])


# ---------------------------------------------------------------------------
# AdamW's norm= and the sharded launcher (--coordinator, --sharding-policy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_norm_defaults_to_the_grads_global_norm(dtype):
    """``norm=`` left out is bitwise the update clipped by
    ``global_norm(grads)`` given explicitly, and a larger norm clips
    harder: the norm the update reports is the one given."""
    from repro_torch.training import global_norm
    cfg = port_config("stablelm_3b", reduced=True)

    def case():
        params = transformer.init_model(
            cfg, torch.Generator().manual_seed(0), "cpu",
            getattr(torch, dtype))
        gen = torch.Generator().manual_seed(1)
        grads = unflatten(params, [torch.randn(p.shape, generator=gen)
                                   for p in leaves(params)])
        return params, grads, init_opt_state(params)

    kw = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    p0, g0, o0 = case()
    p1, g1, o1 = case()
    p2, g2, o2 = case()
    _, _, m0 = adamw_update(kw, p0, g0, o0)
    _, _, m1 = adamw_update(kw, p1, g1, o1, norm=global_norm(g1))
    _, _, m2 = adamw_update(kw, p2, g2, o2, norm=2 * global_norm(g2))
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert torch.equal(m2["grad_norm"], 2 * m1["grad_norm"])
    for a, b in zip(leaves(p0) + leaves(o0), leaves(p1) + leaves(o1)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(leaves(o1["m"]), leaves(o2["m"])))


SHARDED_ARGV = ["--device", "cpu", "--tiny", "--steps", "4", "--seq", "16",
                "--global-batch", "4", "--ckpt-every", "2"]
POLICIES = ("fsdp", "tp_only", "dp_only")
# (arch, policy) of each 2-rank run: the MoE run splits every micro-batch
# over both ranks, so its aux loss needs the whole micro-batch's routing
SHARDED_RUNS = tuple(("stablelm_3b", p) for p in POLICIES) + (
    ("granite_moe_3b_a800m", "dp_only"),)

SHARDED_WORKER = r"""
import os, sys
import torch, torch.distributed as dist
import repro_torch.launch.train as launcher
from repro_torch.checkpoint import restore
from repro_torch.core.tree import leaves
from repro_torch.dist.sharded_train import gather
rdzv, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rank = int(os.environ["RANK"])
real = launcher.init_model
launcher.init_model = lambda cfg, gen, device: real(cfg, gen, device,
                                                    torch.float32)


def own_storage(tree):
    # every local shard holds only its own bytes (no view of the full leaf)
    return all(t.to_local().untyped_storage().nbytes()
               == t.to_local().numel() * t.to_local().element_size()
               for t in leaves(tree))


for i, (arch, policy) in enumerate(%r):
    # the first run joins the group through --coordinator; the later
    # ones find it initialised
    extra = ["--coordinator", "file://" + rdzv] if i == 0 else []
    name = arch + "_" + policy
    ckpt = os.path.join(out, name)
    r = launcher.train(launcher.build_parser().parse_args(
        argv + extra + ["--arch", arch, "--sharding-policy", policy,
                        "--ckpt-dir", ckpt]))
    state = r["state"]
    full = gather(state)
    sharded = sum(t.to_local().numel() < t.numel() for t in leaves(state))
    # the checkpoint back onto this 2-rank mesh: each rank's shards
    back, meta = restore(ckpt, state, shardings=r["placements"],
                         mesh=r["mesh"])
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(leaves(back), leaves(state)))
    if rank == 0:
        torch.save({"losses": r["losses"], "state": full,
                    "sharded_leaves": sharded, "restored_same": same,
                    "own_storage": own_storage(state) and own_storage(back),
                    "step": meta["step"],
                    "mesh": list(r["mesh"].mesh.shape)},
                   os.path.join(out, name + ".pt"))
dist.destroy_process_group()
""" % (SHARDED_RUNS,)


def run_ranks(script: str, args, world: int, tmp, timeout=400):
    """``script`` as ``world`` processes (RANK / WORLD_SIZE set), waited
    for; their output on failure."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    path = tmp / "worker.py"
    path.write_text(script)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "WORLD_SIZE": str(world),
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    procs = [subprocess.Popen([sys.executable, str(path), *map(str, args)],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Tiny f32 runs of 4 steps on two gloo ranks (one launch): stablelm_3b
    under each policy and granite_moe_3b_a800m under dp_only;
    {(arch, policy): rank 0's losses, gathered state, ...}, and the
    one-process run of each arch with the same arguments."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    run_ranks(SHARDED_WORKER, [tmp / "rdzv", tmp, *SHARDED_ARGV], 2, tmp)
    runs = {(a, p): torch.load(tmp / f"{a}_{p}.pt") for a, p in SHARDED_RUNS}
    single = {}
    with pytest.MonkeyPatch.context() as mp:
        _f32_launcher(mp)
        for arch in dict.fromkeys(a for a, _ in SHARDED_RUNS):
            single[arch] = train(build_parser().parse_args(
                SHARDED_ARGV + ["--arch", arch,
                                "--ckpt-dir", str(tmp / f"single_{arch}")]))
    return tmp, runs, single


@pytest.mark.parametrize("arch,policy", [
    pytest.param(a, p, id=p if a == "stablelm_3b" else f"{a}-{p}")
    for a, p in SHARDED_RUNS])
def test_sharded_training_equals_one_process(sharded_runs, arch, policy):
    """Two ranks on a (1, 2) (data, model) mesh: fsdp / tp_only shard
    storage over the model axis (each rank computes every row), dp_only
    splits the batch over both ranks (granite's MoE aux loss then takes
    the router statistics of the whole micro-batch); losses and final
    params within 1e-5 relative of the one-process run (f32 sums in
    another order).  Every local shard owns just its bytes."""
    _, runs, single = sharded_runs
    run, one = runs[arch, policy], single[arch]
    assert run["mesh"] == [1, 2]
    assert (run["sharded_leaves"] > 0) == (policy != "dp_only")
    assert run["own_storage"]
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-5)
    for (path, a), b in zip(leaves_with_paths(run["state"]),
                            leaves(one["state"])):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, path_key(path)
    assert run["restored_same"] and run["step"] == 4


def test_sharded_checkpoint_resumes_on_one_rank(sharded_runs, f32_launcher,
                                                tmp_path):
    """The 2-rank fsdp run's checkpoint (written gathered, by rank 0)
    restores with ``shardings=`` onto a one-rank mesh and resumes to step
    6 bitwise equal to restoring it unsharded."""
    import shutil

    import torch.distributed as dist
    from repro_torch.dist.sharded_train import gather
    src, _, _ = sharded_runs
    argv = SHARDED_ARGV[:SHARDED_ARGV.index("--steps")] + ["--steps", "6"] \
        + SHARDED_ARGV[SHARDED_ARGV.index("--steps") + 2:]
    for name in ("plain", "sharded"):
        shutil.copytree(src / "stablelm_3b_fsdp", tmp_path / name)
    plain = train(build_parser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "plain")]))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        one = train(build_parser().parse_args(
            argv + ["--ckpt-dir", str(tmp_path / "sharded"),
                    "--sharding-policy", "fsdp"]))
        state = gather(one["state"])
    finally:
        dist.destroy_process_group()
    assert plain["start"] == one["start"] == 4
    assert one["losses"] == plain["losses"] and len(one["losses"]) == 2
    _assert_bitwise(state, plain["state"])
