"""The compiled train step (``training.capture``) on the CPU, against the
reference's ``jax.jit(make_train_step(...))``.

On the card the train step replays one CUDA graph per batch shape.
Nothing is captured on the CPU: there ``compiled_train_step(...,
capture=False)`` gives the eager twin (``EagerTrainStep``), the same keys
and static batch buffers over eager steps, its metrics rewritten at every
call of a key and returned as clones.  Held here:

- 4 wrapped steps equal the reference's jitted steps on the same batches
  from the same weights (float32, through ``params_from_jax``), for
  stablelm_3b (n_micro 2, remat True) and granite_moe_3b_a800m (n_micro
  1, remat False), with ``test_torch_training.py``'s tolerances: loss,
  ce and grad_norm 1e-5 relative and lr 1e-6 per step; params and master
  within 1e-4, m 1e-6 and v 1e-8 absolute after the last step (float32
  sums in another order; Adam divides by sqrt(v));
- every step's returned loss keeps its own value after later steps, and
  the wrapped run is bitwise the unwrapped one;
- one key per batch shape; a state leaf other than the one first held
  raises ``ValueError`` before anything runs;
- the train launcher's resume and rollback copy the checkpoint into the
  live leaves, which the step keeps holding;
- the train step makes no host read (what a capture on the card needs).

The ``gpu`` case (skipped without a card) holds 3 captured steps against
3 eager ones bitwise, and a step with a host read fails at capture.  The
module imports JAX only inside the reference comparison, so the card's
machine, which has none, runs the ``gpu`` case:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_capture.py
"""
from __future__ import annotations

import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.tree import (leaves, leaves_with_paths,  # noqa: E402
                                   path_key, tree_map)
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.training import (AdamWConfig, init_opt_state,  # noqa: E402
                                  make_train_step)
from repro_torch.training.capture import (EagerTrainStep,  # noqa: E402
                                          TrainGraphs, batch_key,
                                          compiled_train_step)

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=5, clip_norm=0.25)
STEPS = 4
HOST_READS = {"item", "tolist", "__bool__", "__int__", "__float__",
              "__index__", "numpy", "cpu"}


class NoHostRead(TorchFunctionMode):
    """Raises on any tensor value read back to the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            raise AssertionError(f"host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


def _ref_flat(tree) -> dict:
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        out[path_key(keys)] = np.asarray(leaf, np.float32)
    return out


def _batches(vocab, n=STEPS, seq=16, batch=4):
    data = make_pipeline(DataConfig(vocab_size=vocab, seq_len=seq,
                                    global_batch=batch))
    return [next(data)["tokens"] for _ in range(n)]


def _tiny(arch="stablelm_3b", seed=0):
    """Port params (reduced, f32, seeded) and their AdamW state."""
    cfg = port_config(arch, reduced=True)
    params = transformer.init_model(cfg, torch.Generator().manual_seed(seed),
                                    "cpu", torch.float32)
    return cfg, params, init_opt_state(params)


def _step(cfg, **kw):
    return make_train_step(cfg, AdamWConfig(**OPT), **kw)


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# (a) against the reference's jitted step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_micro,remat", [
    ("stablelm_3b", 2, True), ("granite_moe_3b_a800m", 1, False)])
def test_wrapped_step_matches_the_reference_jit(arch, n_micro, remat):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import init_model
    from repro.training import AdamWConfig as RefAdamW
    from repro.training import init_opt_state as ref_init_opt
    from repro.training import make_train_step as ref_make_step
    from repro_torch.bridge import params_from_jax
    cfg = get_config(arch, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, params))
    rstep = jax.jit(ref_make_step(cfg, RefAdamW(**OPT), n_micro=n_micro,
                                  remat=remat))
    pstep = compiled_train_step(
        _step(port_config(arch, reduced=True), n_micro=n_micro,
              remat=remat), "cpu", capture=False)
    assert isinstance(pstep, EagerTrainStep)
    ropt, popt = ref_init_opt(params), init_opt_state(port)
    for toks in _batches(cfg.vocab_size):
        params, ropt, rm = rstep(params, ropt, {"tokens": jnp.asarray(toks)})
        port, popt, pm = pstep(port, popt, {"tokens": torch.as_tensor(toks)})
        for k in ("loss", "ce", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(popt["step"]) == int(ropt["step"]) == STEPS
    assert len(pstep.steps) == 1
    for got, want, atol in ((port, params, 1e-4),
                            (popt["master"], ropt["master"], 1e-4),
                            (popt["m"], ropt["m"], 1e-6),
                            (popt["v"], ropt["v"], 1e-8)):
        ref = _ref_flat(want)
        for path, t in leaves_with_paths(got):
            np.testing.assert_allclose(t.numpy(), ref[path_key(path)],
                                       rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# (b) - (d) the returned clones, the keys, the held state
# ---------------------------------------------------------------------------

def test_returned_metrics_keep_their_values_and_equal_the_plain_step():
    """Each call's metrics are clones: after 4 steps every loss still holds
    its own step's value, bitwise the unwrapped step's, as do the final
    params and AdamW state; ``step`` counts one update per call."""
    cfg, p0, o0 = _tiny()
    cfg, p1, o1 = _tiny()
    wrapped = compiled_train_step(_step(cfg, n_micro=2), "cpu",
                                  capture=False)
    plain = _step(cfg, n_micro=2)
    got, want = [], []
    for k, toks in enumerate(_batches(cfg.vocab_size), 1):
        batch = {"tokens": torch.as_tensor(toks)}
        p0, o0, m0 = wrapped(p0, o0, batch)
        p1, o1, m1 = plain(p1, o1, batch)
        got.append(m0)
        want.append(m1)
        assert int(o0["step"]) == k
    held = wrapped.steps[batch_key(batch)].metrics
    assert all(m[key] is not held[key] for m in got for key in held)
    assert len({float(m["loss"]) for m in got}) == STEPS
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[key], b[key]) for key in a)
    assert _same(p0, p1) and _same(o0, o1)


def test_one_key_per_batch_shape():
    """A second batch shape adds one key; a shape seen before, none."""
    cfg, params, opt = _tiny()
    step = compiled_train_step(_step(cfg), "cpu", capture=False)
    rng = np.random.default_rng(0)

    def batch(b, s):
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (b, s)))}
    for shape, keys in (((2, 12), 1), ((2, 12), 1), ((4, 12), 2),
                        ((2, 12), 2), ((4, 12), 2)):
        params, opt, _ = step(params, opt, batch(*shape))
        assert len(step.steps) == keys, shape
    assert int(opt["step"]) == 5
    assert set(step.steps) == {
        (("tokens", (b, 12), torch.int64),) for b in (2, 4)}


@pytest.mark.parametrize("where", ["params", "m", "step"])
def test_another_state_leaf_raises(where):
    """A call whose param or AdamW leaf is not the one the step first held
    (a checkpoint swapped in rather than copied into it) raises
    ``ValueError`` naming the leaf, before the step runs."""
    cfg, params, opt = _tiny()
    step = compiled_train_step(_step(cfg), "cpu", capture=False)
    batch = {"tokens": torch.as_tensor(_batches(cfg.vocab_size, 1)[0])}
    params, opt, _ = step(params, opt, batch)
    if where == "params":
        params = dict(params, embed={"table": params["embed"]["table"]
                                     .clone()})
        name = "params/embed/table"
    elif where == "m":
        opt = dict(opt, m=dict(opt["m"], embed={
            "table": opt["m"]["embed"]["table"].clone()}))
        name = "opt_state/m/embed/table"
    else:
        opt = dict(opt, step=opt["step"].clone())
        name = "opt_state/step"
    before = [t.clone() for t in leaves(params) + leaves(opt)]
    with pytest.raises(ValueError, match=name):
        step(params, opt, batch)
    assert all(torch.equal(a, b) for a, b in
               zip(before, leaves(params) + leaves(opt)))


def test_a_step_that_returns_new_state_is_refused():
    """A functional step (new state tensors) cannot be captured: the
    wrapper refuses it at its first call."""
    cfg, params, opt = _tiny()

    def functional(p, o, batch):
        p, o, m = _step(cfg)(p, o, batch)
        return tree_map(torch.Tensor.clone, p), o, m
    step = compiled_train_step(functional, "cpu", capture=False)
    batch = {"tokens": torch.as_tensor(_batches(cfg.vocab_size, 1)[0])}
    with pytest.raises(ValueError, match="in place"):
        step(params, opt, batch)


def test_capture_refuses_the_cpu():
    cfg, _, _ = _tiny()
    with pytest.raises(ValueError, match="CUDA graph"):
        compiled_train_step(_step(cfg), "cpu")


@pytest.mark.parametrize("arch,n_micro,remat", [
    ("stablelm_3b", 2, True), ("granite_moe_3b_a800m", 1, True)])
def test_train_step_makes_no_host_read(arch, n_micro, remat):
    """The whole step (forward, remat's recompute, backward, accumulation,
    clip, AdamW) reads no tensor value back to the host: what a capture
    on the card requires."""
    cfg, params, opt = _tiny(arch)
    batch = {"tokens": torch.as_tensor(_batches(cfg.vocab_size, 1)[0])}
    with NoHostRead():
        _step(cfg, n_micro=n_micro, remat=remat)(params, opt, batch)
    assert int(opt["step"]) == 1


# ---------------------------------------------------------------------------
# (e) the launcher restores into the live state
# ---------------------------------------------------------------------------

ARGV = ["--device", "cpu", "--tiny", "--steps", "10", "--ckpt-every", "5",
        "--seq", "16", "--global-batch", "4"]


@pytest.fixture
def traced_launcher(monkeypatch):
    """The launcher in float32, its compiled steps and drawn params kept."""
    seen = {"steps": [], "params": []}
    real_init, real_compile = launcher.init_model, launcher.compiled_train_step

    def init(cfg, gen, device):
        p = real_init(cfg, gen, device, torch.float32)
        seen["params"].append(p)
        return p

    def compiled(*args, **kw):
        step = real_compile(*args, **kw)
        seen["steps"].append(step)
        return step
    monkeypatch.setattr(launcher, "init_model", init)
    monkeypatch.setattr(launcher, "compiled_train_step", compiled)
    return seen


def _run(ckpt_dir):
    return launcher.train(launcher.build_parser().parse_args(
        ARGV + ["--ckpt-dir", str(ckpt_dir)]))


def test_launcher_resume_and_rollback_keep_the_live_leaves(
        traced_launcher, tmp_path, monkeypatch, capsys):
    """A run resumed at 5 that fails inside step 7's update and rolls
    back to 5: the state it ends with is the params the launcher drew and
    the leaves the step held from its first call (the checkpoint copied
    into them each time), on the CPU's eager twin, and it ends bitwise
    equal to the uninterrupted run."""
    from repro_torch.training import optimizer
    whole = _run(tmp_path / "whole")
    shutil.copytree(tmp_path / "whole", tmp_path / "cut")
    shutil.rmtree(tmp_path / "cut" / "step_0000000010")
    n_leaves = len(leaves(whole["state"]["params"]))
    real, calls = optimizer._decay_mask, []

    def failing_mask(key):
        calls.append(key)
        if len(calls) == 2 * n_leaves + 2:
            raise RuntimeError("injected failure mid-update")
        return real(key)
    monkeypatch.setattr(optimizer, "_decay_mask", failing_mask)
    got = _run(tmp_path / "cut")
    out = capsys.readouterr().out
    assert "resumed at step 5" in out and "rolled back to step 5" in out
    step = traced_launcher["steps"][-1]
    assert isinstance(step, EagerTrainStep) and len(step.steps) == 1
    state = got["state"]
    assert state["params"] is traced_launcher["params"][-1]
    live = leaves({"opt_state": state["opt"], "params": state["params"]})
    assert len(live) == len(step.held)
    assert all(a is b for a, b in zip(live, step.held))
    assert got["losses"] == whole["losses"][5:]
    assert _same(state, whole["state"])


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_captured_steps_are_bitwise_the_eager_steps():
    """Reduced stablelm_3b (bf16, n_micro 2, remat True) on the card: 3
    captured steps (the first eager, then its capture, then 2 replays)
    bitwise equal to 3 eager-twin steps from the same weights, metrics
    and state; one graph; ``step`` counts 3 updates.  A step with a
    host read inside it (``.item()``) raises at its capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture device work")
    cfg = port_config("stablelm_3b", reduced=True)
    runs = []
    for capture in (False, True):
        params = transformer.init_model(
            cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        opt = init_opt_state(params)
        step = compiled_train_step(_step(cfg, n_micro=2), "cuda",
                                   capture=capture)
        metrics = []
        for toks in _batches(cfg.vocab_size, 3):
            params, opt, m = step(params, opt, {
                "tokens": torch.as_tensor(toks, device="cuda")})
            metrics.append(m)
        assert int(opt["step"]) == 3 and len(step.steps) == 1
        runs.append((params, opt, metrics))
        del step
    (p0, o0, m0), (p1, o1, m1) = runs
    assert isinstance(m1, list) and len(m1) == 3
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert _same(p0, p1) and _same(o0, o1)
    torch.cuda.empty_cache()

    def reads(p, o, batch):
        p, o, m = _step(cfg)(p, o, batch)
        m["loss"].item()
        return p, o, m
    params = transformer.init_model(
        cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    opt = init_opt_state(params)
    step = TrainGraphs(reads, torch.device("cuda"))
    with pytest.raises(RuntimeError):
        step(params, opt, {"tokens": torch.as_tensor(
            _batches(cfg.vocab_size, 1)[0], device="cuda")})
