"""The port's ``loadgen`` against the reference's: traces byte-identical,
``summarize`` equal on the same records, and the pinned replay — reduced
``stablelm_3b`` on ``PINNED_STACK`` (paged speculative, the tight block
pool, backpressure and preemption) on the simulated clock — equal to the
reference's replay of the same stack in every counter, metric and stream.
Then the serve CLI's ``--trace`` and ``--calibration`` on the CPU.

The replay runs in float32 on both sides (bridged weights; the
reference's paged scratch prefill through a float32 ``init_cache``), so
streams are identical; the clocks are the two packages' simulators on a
port ``HardwareSpec`` built from the reference's TPU_V5E fields.  The
pinned trace draws token ids below 1024, past the reduced model's
256-token vocabulary: the reference's embedding gather clamps them to the
last row (JAX clamps out-of-range gathers), and the port's raises, so the
port's embedding is given the reference's clamp in this test."""
from __future__ import annotations

import ast
import dataclasses
import functools
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as ref_engine_mod  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import GranularitySpec as RefGran  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.core.simulate import decode_forward_cost as ref_cost  # noqa: E402
from repro.loadgen import generate_trace as ref_generate_trace  # noqa: E402
from repro.loadgen import pinned_spec as ref_pinned_spec  # noqa: E402
from repro.loadgen import replay_trace as ref_replay_trace  # noqa: E402
from repro.loadgen import stats as ref_stats  # noqa: E402
from repro.loadgen import trace as ref_trace  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.transformer import init_paged_cache as ref_paged  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import DEFAULT_SLO_CLASSES as REF_CLASSES  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import PagedKVConfig as RefPaged  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
import repro_torch.models.transformer as port_transformer  # noqa: E402
from repro_torch.autotune import CalibrationMismatchError  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.granularity import GranularitySpec  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.core.simulate import decode_forward_cost  # noqa: E402
from repro_torch.launch.serve import build_parser, serve  # noqa: E402
from repro_torch.loadgen import (PINNED_STACK, generate_trace,  # noqa: E402
                                 pinned_spec, replay_trace, stats, trace)
from repro_torch.serving import (DEFAULT_SLO_CLASSES, AdmissionConfig,  # noqa: E402
                                 DecodeEngine, PagedKVConfig, ServingLoop)

ROOT = Path(__file__).resolve().parents[1]
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))


def _spec_pair(kind, seed):
    """The same TraceSpec built in both packages."""
    if kind == "pinned":
        return pinned_spec(seed=seed), ref_pinned_spec(seed=seed)
    kw = dict(seed=seed, n_requests=24, vocab_size=97)
    port = trace.TraceSpec(
        arrivals=trace.ArrivalSpec(kind=kind, rate_rps=20.0),
        prompt_lens=trace.LengthSpec(dist="lognormal", lo=3, hi=40),
        tenants=(trace.TenantSpec("a", "interactive", 2.0, 8, 0.7),
                 trace.TenantSpec("b", "batch", 1.0)), **kw)
    ref = ref_trace.TraceSpec(
        arrivals=ref_trace.ArrivalSpec(kind=kind, rate_rps=20.0),
        prompt_lens=ref_trace.LengthSpec(dist="lognormal", lo=3, hi=40),
        tenants=(ref_trace.TenantSpec("a", "interactive", 2.0, 8, 0.7),
                 ref_trace.TenantSpec("b", "batch", 1.0)), **kw)
    return port, ref


# ===========================================================================
# (f) traces and summaries
# ===========================================================================

@pytest.mark.parametrize("seed", [0, 7, 20260808])
@pytest.mark.parametrize("kind", ["pinned", "poisson", "mmpp"])
def test_trace_byte_identical(kind, seed):
    port_spec, ref_spec = _spec_pair(kind, seed)
    got = generate_trace(port_spec)
    want = ref_generate_trace(ref_spec)
    assert got.to_json() == want.to_json()
    assert got.fingerprint() == want.fingerprint()
    assert trace.Trace.from_json(got.to_json()).to_json() == got.to_json()


def test_pinned_trace_fingerprint_is_the_committed_one():
    data = json.loads((ROOT / "BENCH_serving.json").read_text())
    assert (generate_trace(pinned_spec()).fingerprint()
            == data["trace_fingerprint"])


@pytest.mark.parametrize("seed", range(4))
def test_summarize_matches_reference(seed):
    rng = np.random.default_rng(seed)
    names = ["interactive", "default", "batch"]
    port_recs, ref_recs = [], []
    for rid in range(20):
        arrival = float(rng.random())
        n = int(rng.integers(0, 6))
        times = list(arrival + np.cumsum(rng.random(n) * 0.1))
        kw = dict(rid=rid, slo_class=names[rid % 3], tenant="t",
                  arrival_s=arrival, token_times=times,
                  rejected=bool(n == 0 and rng.random() < 0.5),
                  preemptions=int(rng.integers(0, 2)))
        port_recs.append(stats.RequestRecord(**kw))
        ref_recs.append(ref_stats.RequestRecord(**dict(
            kw, token_times=list(times))))
    makespan = 2.0
    assert (stats.summarize(port_recs, DEFAULT_SLO_CLASSES, makespan)
            == ref_stats.summarize(ref_recs, REF_CLASSES, makespan))
    for q in (0, 50, 95, 99, 100):
        xs = list(rng.random(7))
        for method in ("nearest_rank", "linear"):
            assert (stats.percentile(xs, q, method)
                    == ref_stats.percentile(xs, q, method))
    assert {k: dataclasses.astuple(v) for k, v in DEFAULT_SLO_CLASSES.items()
            } == {k: dataclasses.astuple(v) for k, v in REF_CLASSES.items()}


# ===========================================================================
# (g) the pinned replay
# ===========================================================================

def _reference_stack():
    """The reference's pinned stack: ``benchmarks/load_harness.py``'s
    module constants, read without importing the benchmark."""
    tree = ast.parse((ROOT / "benchmarks" / "load_harness.py").read_text())
    consts = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return consts


def test_pinned_stack_is_the_reference_benchmarks():
    c = _reference_stack()
    assert dataclasses.astuple(PINNED_STACK) == (
        c["ARCH"], c["MODE"], c["SLOTS"], c["MAX_LEN"], c["KV_BLOCK"],
        c["KV_BLOCKS"], c["MAX_WAITING"], True, c["EPS"])


def _clock(port: bool):
    st = PINNED_STACK
    if port:
        cfg = port_config(st.arch)
        g = GranularitySpec.for_backend(cfg.ffn.n_experts,
                                        head_dim=cfg.attention.head_dim)
        return lambda w, ell: decode_forward_cost(
            cfg, st.slots, w, max(int(ell), 1), g).time(HW)
    cfg = get_config(st.arch)
    g = RefGran.for_backend(cfg.ffn.n_experts,
                            head_dim=cfg.attention.head_dim)
    return lambda w, ell: ref_cost(cfg, st.slots, w, max(int(ell), 1),
                                   g).time(TPU_V5E)


def test_pinned_replay_matches_reference(monkeypatch):
    st = PINNED_STACK
    cfg = get_config(st.arch, reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))
    ref_eng = RefEngine(
        cfg, params, batch=st.slots, max_len=st.max_len,
        paged=RefPaged(block_size=st.kv_block_size, n_blocks=st.kv_blocks),
        cache=ref_paged(cfg, st.kv_blocks + 1, st.kv_block_size,
                        dtype=jnp.float32))
    ref_loop = RefLoop(ref_eng, mode=st.mode, eps=st.eps,
                       step_clock=_clock(False),
                       admission=RefAdmission(max_waiting=st.max_waiting,
                                              preemption=st.preemption))
    want = ref_replay_trace(ref_loop, ref_generate_trace(ref_pinned_spec()))

    embed = port_transformer.embed
    monkeypatch.setattr(
        port_transformer, "embed",
        lambda p, tokens: embed(p, tokens.clamp(0, p["table"].shape[0] - 1)))
    eng = DecodeEngine(
        port_config(st.arch, reduced=True),
        params_from_jax(jax.tree.map(np.asarray, params)), batch=st.slots,
        max_len=st.max_len, hardware=HW, device="cpu",
        paged=PagedKVConfig(block_size=st.kv_block_size,
                            n_blocks=st.kv_blocks))
    loop = ServingLoop(eng, mode=st.mode, eps=st.eps,
                       step_clock=_clock(True),
                       admission=AdmissionConfig(max_waiting=st.max_waiting,
                                                 preemption=st.preemption))
    got = replay_trace(loop, generate_trace(pinned_spec()))

    assert got["clock"] == want["clock"] == "simulated"
    assert got["trace_fingerprint"] == want["trace_fingerprint"]
    assert got["serving"] == want["serving"]
    assert got["makespan_s"] == want["makespan_s"]
    assert got["metrics"] == want["metrics"]
    assert sorted(got["streams"]) == sorted(want["streams"])
    for rid, toks in want["streams"].items():
        np.testing.assert_array_equal(got["streams"][rid], np.asarray(toks))
    # the load pressure the stack exists for
    s = got["serving"]
    assert s["preemptions"] > 0 and s["prefill_positions_saved"] > 0


# ===========================================================================
# (j) the serve CLI: --trace and --calibration on the CPU
# ===========================================================================

def _cli(argv):
    serve(build_parser().parse_args(["--device", "cpu", "--tiny"] + argv))


def test_serve_cli_pinned_trace(capsys, tmp_path):
    out_path = tmp_path / "card.json"
    _cli(["--trace", "pinned", "--requests", "6", "--bench-out",
          str(out_path)])
    out = capsys.readouterr().out
    assert "replayed 6 requests" in out and "simulated clock" in out
    data = json.loads(out_path.read_text())
    assert data["pinned"]["kv_blocks"] == PINNED_STACK.kv_blocks
    assert data["pinned"]["reduced"] is True
    assert data["device"] == "cpu" and data["clock"] == "simulated"
    assert data["metrics"]["completed"] + data["metrics"]["rejected"] == 6


def test_serve_cli_refuses_the_reference_scorecard():
    from repro_torch.launch.serve import check_args
    ap = build_parser()
    args = ap.parse_args(["--trace", "pinned", "--bench-out",
                          "BENCH_serving.json"])
    with pytest.raises(SystemExit):
        check_args(ap, args)


def test_serve_cli_calibration_run_then_load(capsys, tmp_path):
    path = str(tmp_path / "calib.json")
    base = ["--requests", "3", "--tokens", "6", "--serve-mode",
            "speculative", "--calibration-path", path]
    _cli(base + ["--calibration", "run"])
    out = capsys.readouterr().out
    assert "via the simulator backend" in out and "budget control:" in out
    assert "L<=64: analytic=" in out
    _cli(base + ["--calibration", "load"])
    out = capsys.readouterr().out
    assert "calibration: loaded" in out and "served 3 requests" in out
    with pytest.raises(CalibrationMismatchError, match="stale"):
        _cli(base + ["--calibration", "load", "--slots", "2"])
