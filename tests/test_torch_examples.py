"""The port's example drivers (``repro_torch.examples``) and the serve
launcher's ``--ckpt-dir`` / ``--batch`` against the reference on the CPU.

Forwards are compared on the same float32 weights through
``params_from_jax``, where the two stacks agree to float32 rounding:
token streams and driver statistics must be identical, logits agree
within ``LOGIT_TOL``.  The NFP numbers are host arithmetic on the same
configs and must be equal.  Budgets that reach an engine are the H100's
on both sides (a reference ``HardwareSpec`` built from the port's H100
fields).  Two faults of the reference are pinned here: its serve
launcher serves random weights when ``--ckpt-dir`` holds no checkpoint,
and its ``examples/train_lm.py`` labels a checkpoint one step early and
resumes on batch 0."""
from __future__ import annotations

import dataclasses
import importlib.util
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as ref_serve  # noqa: E402
from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import core as ref_core  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import DiffusionBlockDecoder as RefDiffusion  # noqa: E402
from repro.serving import SpeculativeDecoder as RefSpeculative  # noqa: E402
from repro.training import init_opt_state as ref_init_opt  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.checkpoint import save  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.hardware import H100  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.examples import (nfp_survey, quickstart,  # noqa: E402
                                  serve_parallel_decode, train_lm)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.specs import params_abstract  # noqa: E402
from repro_torch.launch.train import build_parser as train_parser  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_H100 = ref_core.HardwareSpec(**dataclasses.asdict(H100))
# float32 logits of the two stacks: two layers of rounding
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(arch):
    cfg = get_config(arch, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return (cfg, params, port_config(arch, reduced=True),
            params_from_jax(jax.tree.map(np.asarray, params)))


def _ref_engine(cfg, params, batch, max_len):
    return RefEngine(cfg, params, batch=batch, max_len=max_len,
                     hardware=REF_H100,
                     cache=ref_init_cache(cfg, batch, max_len,
                                          dtype=jnp.float32))


def _same_tree(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _serve(argv):
    ap = serve_mod.build_parser()
    args = ap.parse_args(["--device", "cpu", "--tiny"] + argv)
    serve_mod.check_args(ap, args)
    return serve_mod.serve(args)


# ===========================================================================
# nfp_survey
# ===========================================================================

@pytest.mark.parametrize("hw", nfp_survey.HARDWARE)
def test_nfp_survey_rows_equal_reference(hw):
    """Every arch x b x ell row: N_max, n_idle, over-prediction and the
    limiting term equal the reference's ``predict_model`` (the H100 rows:
    on a reference spec of the port's H100 fields)."""
    ref_hw = REF_H100 if hw == "h100" else ref_core.get_hardware(hw)
    rows = [r for r in nfp_survey.survey() if r[1] == hw]
    assert len(rows) == 12 * 2 * 2
    for arch, _, b, ell, got in rows:
        cfg = get_config(arch)
        want = ref_core.predict_model(
            cfg, ref_hw, ref_core.GranularitySpec.for_backend(
                cfg.ffn.n_experts), b, ell)
        assert (got.n_max, got.n_idle, got.overprediction, got.limiting) == (
            want.n_max, want.n_idle, want.overprediction, want.limiting), \
            (arch, b, ell)


def test_nfp_survey_main_prints_every_row(capsys):
    rows = nfp_survey.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(rows) == len(lines) - 1 == 144
    assert lines[1].split()[:4] == ["stablelm_3b", "h100", "1", "4096"]


# ===========================================================================
# quickstart
# ===========================================================================

def test_quickstart_predictions_equal_reference():
    """The H20 prediction, the module-level over-prediction and N_max(0.2)
    of the curve simulated on the H100's fields equal the reference's."""
    got = quickstart.predictions()
    cfg = get_config(quickstart.ARCH)
    gran = ref_core.GranularitySpec.for_backend(n_experts=cfg.ffn.n_experts)
    pred = ref_core.predict_model(cfg, ref_core.H20, gran, b=1, ell=4096)
    mod = ref_core.predict_moe_balanced(ref_core.H20, gran,
                                        cfg.ffn.n_experts, cfg.ffn.top_k,
                                        cfg.ffn.d_ff)
    assert (got["h20"].n_max, got["h20"].limiting, got["h20"].n_idle) == (
        pred.n_max, pred.limiting, pred.n_idle)
    assert (got["module_h20"].n_idle, got["module_h20"].overprediction) == (
        mod.n_idle, mod.overprediction)
    base_n = ref_core.balanced_moe_baseline_n(cfg.ffn.n_experts, 1,
                                              cfg.ffn.top_k)
    ns = sorted(set(range(1, 129)) | {base_n})
    pts = ref_core.latency_curve(cfg, REF_H100, 1, 4096, ns, gran)
    curve = ref_core.LatencyCurve([n for n, _ in pts], [t for _, t in pts],
                                  baseline_n=base_n)
    assert got["baseline_n"] == base_n
    assert got["nmax_simulated"] == ref_core.extract_nmax(curve, 0.2)
    want = ref_core.predict_model(cfg, REF_H100, gran, b=1, ell=4096)
    assert (got["target"].n_max, got["target"].limiting) == (
        want.n_max, want.limiting)


def test_quickstart_tiny_decode_matches_reference():
    """Step 4 on bridged float32 tiny llada (E 16, top-2): the same
    engine budget, and the decode logits of the same prompt and draft
    within LOGIT_TOL."""
    cfg, params, pcfg, port = _f32(quickstart.ARCH)
    got = quickstart.tiny_decode(pcfg, port, np.random.default_rng(3),
                                 "cpu")
    ref = _ref_engine(cfg, params, 1, quickstart.MAX_LEN)
    ref.prefill(jnp.asarray(got["prompt"]))
    assert ref.nfp_budget() == got["budget"]
    assert got["n"] == min(got["budget"], quickstart.MAX_N)
    want = ref.decode_step(jnp.asarray(got["draft"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               **LOGIT_TOL)


def test_quickstart_main_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["logits"].shape == (1, out["n"], out["small"].vocab_size)
    assert torch.isfinite(out["logits"]).all() and not out["use_kernel"]
    assert "tiny-model engine: budget=" in capsys.readouterr().out


# ===========================================================================
# serve_parallel_decode
# ===========================================================================

def test_serve_parallel_decode_matches_reference():
    """AR, speculative (gamma = min(budget - 1, 8)) and diffusion (block
    min(budget - 1, 12), 3 refinements) on bridged float32 reduced
    stablelm: the same streams and statistics as the reference's drivers,
    and speculative lossless."""
    cfg, params, pcfg, port = _f32(serve_parallel_decode.ARCH)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, serve_parallel_decode.PROMPT_LEN))
    got = serve_parallel_decode.run(pcfg, port, prompt, "cpu")
    tokens, max_len = serve_parallel_decode.TOKENS, serve_parallel_decode.MAX_LEN
    jprompt = jnp.asarray(prompt)
    ar = np.asarray(_ref_engine(cfg, params, 1, max_len).greedy_generate(
        jprompt, tokens)[0])
    eng = _ref_engine(cfg, params, 1, max_len)
    budget = eng.nfp_budget()
    spec = RefSpeculative(eng, gamma=min(budget - 1, 8)).generate(jprompt,
                                                                  tokens)
    diff = RefDiffusion(_ref_engine(cfg, params, 1, max_len),
                        block_size=min(budget - 1, 12),
                        refine_steps=3).generate(jprompt, tokens)
    assert got["budget"] == budget and got["lossless"]
    np.testing.assert_array_equal(got["ar"]["tokens"], ar)
    for mode, (toks, stats) in (("speculative", spec), ("diffusion", diff)):
        np.testing.assert_array_equal(got[mode]["tokens"], np.asarray(toks))
        assert got[mode]["stats"] == stats, mode


# ===========================================================================
# train_lm
# ===========================================================================

def _ref_example(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_100m_equals_reference():
    """Field for field, and the same parameter count (the reference's by
    ``jax.eval_shape``, the port's on fake tensors): 75.5e6 with the tied
    embedding, the "~100M" of both drivers."""
    ref_cfg = _ref_example("train_lm").model_100m()
    cfg = train_lm.model_100m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    shapes = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0),
                                               ref_cfg))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(t.numel() for t in leaves(params_abstract(cfg))) == want


def _train_lm(tmp, steps):
    return train_lm.main(["--device", "cpu", "--tiny", "--steps", str(steps),
                          "--ckpt-every", "2", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp)])


def test_train_lm_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """--tiny for 6 steps, against 4 steps then a run to 6 on the same
    directory: the resume starts at 4 (the checkpoint holds 4 updates)
    on batch 4, and ends with the same params and AdamW state, bitwise.
    Both runs are inside the 20-step warmup, where the schedule does not
    depend on --steps."""
    whole = _train_lm(tmp_path / "whole", 6)
    first = _train_lm(tmp_path / "cut", 4)
    second = _train_lm(tmp_path / "cut", 6)
    assert (whole["start"], first["start"], second["start"]) == (0, 0, 4)
    assert len(second["losses"]) == 2
    assert second["losses"] == whole["losses"][4:]
    assert first["losses"] == whole["losses"][:4]
    assert _same_tree(second["state"], whole["state"])
    assert int(second["state"]["opt"]["step"]) == 6


def test_reference_train_lm_example_labels_early_and_resumes_on_batch_0(
        tmp_path, monkeypatch):
    """Faults of the reference's ``examples/train_lm.py`` the port's
    example does not copy (as its launcher's, pinned in
    ``test_torch_checkpoint.py``): a checkpoint saved after the update of
    step index s is labelled s (``:78-79``), so ``step_2`` holds 3 updates;
    and a resumed run builds its stream anew (``:53-56``): from ``step_2``
    it trains step 2 on batch 0."""
    ex = _ref_example("train_lm")
    seen = []

    def recording(cfg):
        for batch in ex_pipeline(cfg):
            seen[-1].append(np.asarray(batch["tokens"]))
            yield batch
    ex_pipeline = ex.make_pipeline
    monkeypatch.setattr(ex, "make_pipeline", recording)
    argv = ["train_lm.py", "--tiny", "--steps", "3", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path), "--seq", "16", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", argv)
    seen.append([])
    ex.main()
    with np.load(tmp_path / "step_0000000002" / "arrays.npz") as arrays:
        assert int(arrays["opt/step"]) == 3
    shutil.rmtree(tmp_path / "step_0000000003")
    seen.append([])
    ex.main()
    first, again = seen
    assert len(first) == 3 and len(again) == 1
    np.testing.assert_array_equal(again[0], first[0])
    assert not np.array_equal(again[0], first[2])


# ===========================================================================
# serve --ckpt-dir and --batch
# ===========================================================================

def test_serve_ckpt_dir_serves_a_reference_checkpoint_bitwise(tmp_path):
    """A checkpoint the reference's ``checkpoint.save`` wrote (tiny
    stablelm, bf16 ``params`` and ``opt``): the port serves its params bit
    for bit."""
    cfg = get_config("stablelm_3b", reduced=True)
    params = init_model(jax.random.PRNGKey(3), cfg)
    ref_ckpt.save(str(tmp_path), 7, {"params": params,
                                     "opt": ref_init_opt(params)},
                  {"step": 7})
    out = _serve(["--ckpt-dir", str(tmp_path), "--requests", "2", "--slots",
                  "2", "--tokens", "3"])
    assert _same_tree(out["params"],
                      params_from_jax(jax.tree.map(np.asarray, params)))
    assert all(len(t) == 3 for t in out["streams"].values())


def test_serve_ckpt_dir_serves_what_the_train_launcher_wrote(tmp_path):
    """Three steps of the port's train launcher, then ``--ckpt-dir``: the
    served params are the trained ones, the stream is an engine's on them,
    and it differs from the stream of the random init of ``--seed``."""
    trained = train(train_parser().parse_args(
        ["--device", "cpu", "--tiny", "--steps", "3", "--lr", "1e-2",
         "--global-batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)]))["state"]["params"]
    argv = ["--algorithm", "greedy", "--tokens", "8"]
    out = _serve(argv + ["--ckpt-dir", str(tmp_path)])
    assert _same_tree(out["params"], trained)
    cfg = port_config("stablelm_3b", reduced=True)
    eng = DecodeEngine(cfg, trained, batch=1, max_len=256, device="cpu")
    want = eng.greedy_generate(torch.as_tensor(out["prompts"]), 8).numpy()
    np.testing.assert_array_equal(out["streams"], want)
    random = _serve(argv)
    assert not _same_tree(random["params"], trained)
    assert not np.array_equal(random["streams"], out["streams"])


def test_serve_ckpt_dir_refuses_what_it_cannot_serve(tmp_path):
    """No committed checkpoint raises (the reference serves random weights
    there); so do a checkpoint lacking a leaf of the config and one
    whose leaf has another shape."""
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        _serve(["--ckpt-dir", str(tmp_path), "--algorithm", "greedy"])
    params = params_from_jax(jax.tree.map(np.asarray, init_model(
        jax.random.PRNGKey(0), get_config("stablelm_3b", reduced=True))))
    save(str(tmp_path / "partial"), 1,
         {"params": {k: v for k, v in params.items() if k != "final_norm"}})
    with pytest.raises(ValueError, match="final_norm"):
        _serve(["--ckpt-dir", str(tmp_path / "partial"), "--algorithm",
                "greedy"])
    save(str(tmp_path / "other"), 1, {"params": params})
    with pytest.raises(ValueError, match="shape"):
        _serve(["--ckpt-dir", str(tmp_path / "other"), "--arch",
                "wedlm8b_like", "--algorithm", "greedy"])


def test_serve_batch_greedy_returns_every_row():
    """``--algorithm greedy --batch 2``: two rows, each its own prompt,
    equal to the engine's ``greedy_generate`` on the same params."""
    out = _serve(["--algorithm", "greedy", "--batch", "2", "--tokens", "5"])
    cfg = port_config("stablelm_3b", reduced=True)
    assert out["prompts"].shape == (2, 16) and out["streams"].shape == (2, 5)
    assert not np.array_equal(out["prompts"][0], out["prompts"][1])
    eng = DecodeEngine(cfg, out["params"], batch=2, max_len=256,
                       device="cpu")
    want = eng.greedy_generate(torch.as_tensor(out["prompts"]), 5).numpy()
    np.testing.assert_array_equal(out["streams"], want)
    spec = _serve(["--algorithm", "speculative", "--batch", "2", "--tokens",
                   "5"])
    assert spec["streams"].shape == (1, 5)        # the drivers follow row 0


@pytest.mark.parametrize("argv", [["--batch", "2"],
                                  ["--algorithm", "greedy", "--batch", "0"]],
                         ids=["without-algorithm", "zero"])
def test_serve_batch_refused_outside_the_single_request_path(argv):
    ap = serve_mod.build_parser()
    with pytest.raises(SystemExit):
        serve_mod.check_args(ap, ap.parse_args(["--device", "cpu"] + argv))


def test_reference_serve_serves_random_weights_from_an_empty_ckpt_dir(
        tmp_path, monkeypatch, capsys):
    """A fault of the reference the port does not copy
    (``src/repro/launch/serve.py:280``): with no committed checkpoint in
    ``--ckpt-dir`` it silently serves the random init of PRNGKey(0)."""
    served = {}
    monkeypatch.setattr(ref_serve, "_single_request",
                        lambda args, cfg, params: served.update(p=params))
    monkeypatch.setattr(sys, "argv", [
        "serve", "--tiny", "--ckpt-dir", str(tmp_path), "--algorithm",
        "greedy", "--tokens", "2"])
    ref_serve.main()
    assert "loaded checkpoint" not in capsys.readouterr().out
    want = init_model(jax.random.PRNGKey(0),
                      get_config("stablelm_3b", reduced=True))
    for a, b in zip(jax.tree.leaves(served["p"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
