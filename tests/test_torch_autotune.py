"""The port's timing and modelling cores and its ``autotune`` against the
reference's, on the same inputs: the roofline simulator, the knee /
sensitivity / staircase extraction, ``calibrate_specs`` on the simulator
backend, spec fingerprints and saved tables, the ``BudgetController``,
and a ``ServingLoop`` driven by a controller and a step clock.  Then the
port's own parts: the torch timer, wall-clock ``calibrate_engine`` on a
CPU engine (its state restored, its guards raising), and the refusal of
a CUDA-graph capture on the CPU.

Tolerances: the simulator's times to rel 1e-12 (the same float64
formulas; observed equal); everything else exact — the same integer and
float64 arithmetic in the same order, and, for the serving loop, float32
weights, under which the two stacks' token streams are identical (see
``test_torch_serving.py``)."""
from __future__ import annotations

import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as ref_engine_mod  # noqa: E402
from repro.autotune import BudgetController as RefController  # noqa: E402
from repro.autotune import ControllerConfig as RefControllerConfig  # noqa: E402
from repro.autotune import calibrate_specs as ref_calibrate_specs  # noqa: E402
from repro.autotune import save_table as ref_save_table  # noqa: E402
from repro.autotune import spec_fingerprint as ref_fingerprint  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import GranularitySpec as RefGran  # noqa: E402
from repro.core import measure as ref_measure  # noqa: E402
from repro.core.hardware import HardwareSpec as RefHardware  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.core.simulate import decode_forward_cost as ref_cost  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import ServingLoop as RefLoop  # noqa: E402
from repro_torch.autotune import (BudgetController, CalibrationMismatchError,  # noqa: E402
                                  ControllerConfig, calibrate_engine,
                                  calibrate_specs, load_table, save_table,
                                  spec_fingerprint)
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import measure  # noqa: E402
from repro_torch.core.granularity import GranularitySpec  # noqa: E402
from repro_torch.core.hardware import H100, HardwareSpec  # noqa: E402
from repro_torch.core.simulate import decode_forward_cost  # noqa: E402
from repro_torch.serving import (DecodeEngine, PagedKVConfig,  # noqa: E402
                                 ServingLoop)

ARCHS = ["stablelm_3b", "granite_moe_3b_a800m", "falcon_mamba_7b",
         "wedlm8b_like", "llada_mini_like"]
#: the two hardware specs of the comparisons: the port's H100 and a port
#: spec built from the reference's TPU_V5E fields
SPECS = {"h100": (H100, RefHardware(**dataclasses.asdict(H100))),
         "tpu_v5e_fields": (HardwareSpec(**dataclasses.asdict(TPU_V5E)),
                            TPU_V5E)}
GRID = [(b, n, ell) for b in (1, 4, 9) for n in (1, 2, 5, 16, 17, 64, 65)
        for ell in (1, 64, 256, 1000)]


def _grans(cfg_port, cfg_ref, kv_page=0):
    head = cfg_ref.attention.head_dim if cfg_ref.attention else 128
    return (GranularitySpec.for_backend(cfg_port.ffn.n_experts,
                                        head_dim=head, kv_page=kv_page),
            RefGran.for_backend(cfg_ref.ffn.n_experts, head_dim=head,
                                kv_page=kv_page))


def _configs(arch, reduced=False):
    return port_config(arch, reduced=reduced), get_config(arch,
                                                          reduced=reduced)


# ===========================================================================
# (a) the roofline simulator
# ===========================================================================

@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("arch", ARCHS)
def test_simulator_matches_reference(arch, spec):
    cp, cr = _configs(arch)
    gp, gr = _grans(cp, cr)
    hp, hr = SPECS[spec]
    for b, n, ell in GRID:
        want = ref_cost(cr, b, n, ell, gr).time(hr)
        got = decode_forward_cost(cp, b, n, ell, gp).time(hp)
        assert got == pytest.approx(want, rel=1e-12), (b, n, ell)
        assert (decode_forward_cost(cp, b, n, ell, gp).limiting_module(hp)
                == ref_cost(cr, b, n, ell, gr).limiting_module(hr))


# ===========================================================================
# (b) knee, sensitivity and staircase extraction
# ===========================================================================

def _curve(seed):
    rng = np.random.default_rng(seed)
    ns = sorted({1} | {int(x) for x in rng.integers(2, 130, size=14)})
    # a noisy staircase: flat, then steps
    times = [1.0 + 0.05 * rng.random() + 0.3 * (n // int(rng.integers(
        8, 40))) for n in ns]
    spreads = list(rng.random(len(ns)) * 0.1)
    return ns, times, spreads


@pytest.mark.parametrize("seed", range(6))
def test_knee_sensitivity_staircase_match_reference(seed):
    ns, times, spreads = _curve(seed)
    port = measure.LatencyCurve(ns, times, 1, spreads)
    ref = ref_measure.LatencyCurve(ns, times, 1, spreads)
    for eps in (0.05, 0.1, 0.2, 0.3, 0.5):
        for contiguous in (False, True):
            assert (measure.extract_nmax(port, eps, contiguous)
                    == ref_measure.extract_nmax(ref, eps, contiguous))
    assert measure.sensitivity_sweep(port) == ref_measure.sensitivity_sweep(
        ref)
    assert port.max_spread == ref.max_spread
    for jump in (0.01, 0.05, 0.2):
        assert (measure.staircase_boundaries(ns, times, jump)
                == ref_measure.staircase_boundaries(ns, times, jump))
    assert (measure.balanced_moe_baseline_n(40, 4, 8)
            == ref_measure.balanced_moe_baseline_n(40, 4, 8))


def test_time_callable_on_the_cpu_counts_rounds():
    calls = []
    med, spread = measure.time_callable(lambda: calls.append(1), warmup=2,
                                        rounds=3, iters=4)
    assert len(calls) == 2 + 3 * 4
    assert med >= 0.0 and spread >= 0.0
    curve = measure.sweep_callable(lambda n: (lambda: None), [1, 2, 4],
                                   warmup=0, rounds=2, iters=2)
    assert curve.ns == [1, 2, 4] and len(curve.spreads) == 3


# ===========================================================================
# (c) calibrate_specs on the simulator backend, (d) fingerprints and tables
# ===========================================================================

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_specs_matches_reference(arch, reduced):
    cp, cr = _configs(arch, reduced)
    gp, gr = _grans(cp, cr)
    hp, hr = SPECS["tpu_v5e_fields"]
    kw = dict(batch=4, max_len=1024, modes=("greedy", "speculative"),
              kernels=(False, True), eps=0.2)
    got = calibrate_specs(cp, hp, gp, **kw)
    want = ref_calibrate_specs(cr, hr, gr, **kw)
    assert got.to_json() == want.to_json()
    assert [e.overprediction for e in got.entries] == [
        e.overprediction for e in want.entries]
    assert [e.idle_overprediction for e in got.entries] == [
        e.idle_overprediction for e in want.entries]


@pytest.mark.parametrize("kv_page", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_fingerprint_and_reference_table_load(arch, kv_page, tmp_path):
    cp, cr = _configs(arch)
    gp, gr = _grans(cp, cr, kv_page)
    hp, hr = SPECS["h100"]
    for kernels, batch, eps in (((True,), 4, 0.2), ((False, True), 2, 0.1)):
        assert (spec_fingerprint(cp, hp, gp, kernels, batch, eps)
                == ref_fingerprint(cr, hr, gr, kernels, batch, eps))
    path = str(tmp_path / "ref.json")
    ref_save_table(ref_calibrate_specs(cr, hr, gr, batch=4, max_len=256,
                                       modes=("greedy",)), path)
    key = spec_fingerprint(cp, hp, gp, (False,), 4, 0.2)
    table = load_table(path, expect_key=key)
    assert table.key == key and table.budget("greedy", 100) >= 1
    with pytest.raises(CalibrationMismatchError, match="stale"):
        load_table(path, expect_key=spec_fingerprint(cp, hp, gp, (False,),
                                                     2, 0.2))


# ===========================================================================
# (e) the BudgetController
# ===========================================================================

def _tables(arch="granite_moe_3b_a800m"):
    cp, cr = _configs(arch)
    gp, gr = _grans(cp, cr)
    hp, hr = SPECS["tpu_v5e_fields"]
    kw = dict(batch=4, max_len=1024, modes=("speculative",))
    return calibrate_specs(cp, hp, gp, **kw), ref_calibrate_specs(
        cr, hr, gr, **kw)


@pytest.mark.parametrize("clocked", [False, True])
@pytest.mark.parametrize("table", [False, True], ids=["no-table", "table"])
@pytest.mark.parametrize("seed", range(3))
def test_budget_controller_matches_reference(seed, table, clocked):
    tp, tr = _tables() if table else (None, None)
    cfg = dict(patience=2, cooldown=3, baseline_grace=3, noise_floor=0.01)
    port = BudgetController(tp, ControllerConfig(**cfg))
    ref = RefController(tr, RefControllerConfig(**cfg))
    port.bind("speculative", True, clocked=clocked)
    ref.bind("speculative", True, clocked=clocked)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        ell = int(rng.choice([10, 64, 100, 300, 1000, 5000]))
        n_active = int(rng.integers(0, 5))
        analytic = int(rng.integers(1, 80))
        assert (port.budget(ell, n_active, analytic)
                == ref.budget(ell, n_active, analytic))
        assert (port.table_budget(ell, n_active, analytic)
                == ref.table_budget(ell, n_active, analytic))
        width = int(rng.integers(1, 20))
        latency = float(rng.choice([0.0, -1.0, float("nan")])
                        if rng.random() < 0.05 else
                        1e-3 * (1 + 0.05 * width * rng.random()))
        assert port.observe(ell, width, latency) == ref.observe(
            ell, width, latency)
    assert port.stats() == ref.stats()


# ===========================================================================
# (h) ServingLoop with a controller and a step clock
# ===========================================================================

MAX_LEN, SLOTS = 128, 4


def _clocks(arch):
    """The same simulated step clock in both packages: the full-size
    config on the TPU_V5E fields, at the table's bucket."""
    cp, cr = _configs(arch)
    gp, gr = _grans(cp, cr)
    hp, hr = SPECS["tpu_v5e_fields"]
    return (lambda w, ell: decode_forward_cost(cp, SLOTS, w, ell, gp).time(hp),
            lambda w, ell: ref_cost(cr, SLOTS, w, ell, gr).time(hr))


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite_moe_3b_a800m", reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("table", [False, True], ids=["no-table", "table"])
@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_controlled_serving_loop_matches_reference(granite, mode, table,
                                                   monkeypatch):
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))
    cfg, params, port_params = granite
    pcfg = port_config("granite_moe_3b_a800m", reduced=True)
    tp, tr = _tables() if table else (None, None)
    clock_p, clock_r = _clocks("granite_moe_3b_a800m")
    hw = SPECS["tpu_v5e_fields"][0]
    ref_eng = RefEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                        cache=ref_init_cache(cfg, SLOTS, MAX_LEN,
                                             dtype=jnp.float32))
    ref = RefLoop(ref_eng, mode=mode, controller=RefController(tr),
                  step_clock=clock_r)
    eng = DecodeEngine(pcfg, port_params, batch=SLOTS, max_len=MAX_LEN,
                       hardware=hw, device="cpu")
    port = ServingLoop(eng, mode=mode, controller=BudgetController(tp),
                       step_clock=clock_p)
    rng = np.random.default_rng(3)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, size=6 + i)
        ref.submit(prompt, 10)
        port.submit(prompt, 10)
    want, got = ref.run(), port.run()
    assert sorted(want) == sorted(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    keys = ("active", "width", "positions", "budget", "budget_analytic",
            "budget_calibrated", "ell", "step_latency_s", "latency_ratio")
    assert ([{k: e[k] for k in keys if k in e} for e in port.step_log]
            == [{k: e[k] for k in keys if k in e} for e in ref.step_log])
    ps, rs = port.stats(), ref.stats()
    for k in rs:
        if not k.startswith(("kv_tile", "mean_kv", "mean_attn")):
            assert ps[k] == rs[k], k
    if table:
        assert any("budget_calibrated" in e for e in port.step_log)


# ===========================================================================
# (i) wall-clock calibrate_engine on a CPU engine; (k) capture on the CPU
# ===========================================================================

@pytest.fixture(scope="module")
def stablelm():
    cfg = port_config("stablelm_3b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import init_model as port_init
    return cfg, port_init(cfg, gen, "cpu", dtype=torch.float32)


def test_wallclock_calibration_on_a_cpu_engine(stablelm):
    """The wallclock backend times real decode_slots forwards (the plain
    versions, host clock): a well-formed table, the engine's state and
    static buffers restored, and the cache-headroom, paged and live-slot
    guards raising."""
    cfg, params = stablelm
    eng = DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu",
                       capture=False)
    lens_buf = eng.slot_lens
    cache_leaves = [t for seg in eng.cache["segments"] for t in seg.values()]
    t = calibrate_engine(eng, modes=("greedy",), backend="wallclock",
                         ns=(1, 2), warmup=0, rounds=1, iters=1)
    assert t.backend == "wallclock"
    for e in t.entries:
        assert e.ell + 2 <= eng.max_len
        assert all(x > 0 for x in e.times)
        assert e.noise >= 0.0
        assert 1 <= e.calibrated_budget <= e.analytic_nmax
    assert eng.slot_lens is lens_buf                 # the same buffer
    assert torch.equal(eng.slot_lens, torch.zeros(2, dtype=torch.int32))
    assert np.array_equal(eng.slot_lens_host, np.zeros(2, np.int64))
    assert eng.use_kernel is False and eng.cache_len == 0
    assert [t for seg in eng.cache["segments"]
            for t in seg.values()] == cache_leaves
    assert calibrate_engine(eng, backend="auto").backend == "simulator"
    t2 = calibrate_engine(eng, modes=("greedy",), backend="simulator")
    assert all(e.ell + max(e.ns) <= eng.max_len for e in t2.entries)
    with pytest.raises(ValueError, match="overruns"):
        calibrate_engine(eng, modes=("greedy",), backend="wallclock",
                         ns=(1, 63), buckets=(64,))
    eng.prefill_slots({0: np.arange(40) % cfg.vocab_size})
    with pytest.raises(ValueError, match="overwrite"):
        calibrate_engine(eng, modes=("greedy",), backend="wallclock",
                         ns=(1, 2), buckets=(8, 32))
    paged = DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu",
                         paged=PagedKVConfig(block_size=16))
    with pytest.raises(ValueError, match="paged"):
        calibrate_engine(paged, backend="wallclock", ns=(1, 2))
    with pytest.raises(ValueError, match="backend"):
        calibrate_engine(eng, backend="stopwatch")


def test_capture_on_the_cpu_raises(stablelm):
    cfg, params = stablelm
    with pytest.raises(ValueError, match="CUDA graph"):
        DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu",
                     capture=True)
    eng = DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu")
    assert eng.capture is False and eng.graphs is None


def test_saved_table_round_trips(stablelm, tmp_path):
    cfg, params = stablelm
    eng = DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu")
    table = calibrate_engine(eng, modes=("greedy",))
    path = str(tmp_path / "t.json")
    save_table(table, path)
    back = load_table(path, expect_key=table.key)
    assert back.to_json() == table.to_json()
    data = json.loads(open(path).read())
    data["schema"] = 99
    open(path, "w").write(json.dumps(data))
    with pytest.raises(CalibrationMismatchError, match="schema"):
        load_table(path)
