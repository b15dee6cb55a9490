"""The reference's last public functions, copied into the port: the
paper's predictors and arithmetic intensities (``core.nfp``), its GPU
presets (``core.hardware``), ``configs.all_configs``,
``models.attention.init_paged_kv_cache`` and the aligned-rows
``decode_attention`` entry, each against the reference.

The predictors are pure float arithmetic in the same order, so they are
held equal, not close: on H20 / A800 / H800 (the paper's Table 2) and the
port's H100, for all twelve configs (``predict_model`` at two batches and
two lengths) and the paper's Table 24 cases of ``tests/test_nfp_core.py``.
``decode_attention`` runs the plain path on the CPU against the
reference's Pallas kernel in interpret mode, f32, within 2e-5.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.configs import all_configs as ref_all_configs  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels.decode_attention import ops as ref_ops  # noqa: E402
from repro.models.attention import \
    init_paged_kv_cache as ref_init_paged  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PAPER_IDS, all_configs,  # noqa: E402
                                 get_config)
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.models.attention import init_paged_kv_cache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GPUS = ("h20", "a800", "h800", "h100")
ATOL = RTOL = 2e-5


def _hw(name):
    """(port, reference) HardwareSpec of a preset (the reference has no
    H100 preset: one with the port's fields)."""
    port = core.get_hardware(name)
    ref = (ref_core.get_hardware(name) if name != "h100" else
           ref_core.HardwareSpec(**dataclasses.asdict(port)))
    return port, ref


def _same(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _gran(cfg, ref_cfg):
    e = cfg.ffn.n_experts if cfg.ffn.kind == "moe" else 0
    port = core.GranularitySpec.for_backend(n_experts=e)
    ref = ref_core.GranularitySpec.for_backend(n_experts=e)
    assert _same(port, ref)
    return port, ref


@pytest.mark.parametrize("name", ("h20", "a800", "h800"))
def test_paper_gpus_are_the_references(name):
    from repro_torch.core import hardware
    port, ref = _hw(name)
    assert _same(port, ref)
    assert hardware.PRESETS[name] is port


def test_h100_stays_the_default_and_no_tpu_preset():
    from repro_torch.core import hardware
    assert set(hardware.PRESETS) == {"h100", "h20", "a800", "h800"}
    assert hardware.get_hardware("h100") is hardware.H100


@pytest.mark.parametrize("gpu", GPUS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_predictors_equal_the_references(arch, gpu):
    """``predict_model`` at b 1 / 4 and L 512 / 4096, and the module
    predictors and intensities at the config's widths."""
    hw, ref_hw = _hw(gpu)
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    gran, ref_gran = _gran(cfg, ref_cfg)
    for b in (1, 4):
        for ell in (512, 4096):
            for routing in ("balanced", "skewed"):
                assert _same(core.predict_model(cfg, hw, gran, b, ell,
                                                routing),
                             ref_core.predict_model(ref_cfg, ref_hw,
                                                    ref_gran, b, ell,
                                                    routing))
        assert _same(core.predict_dense(hw, gran, b),
                     ref_core.predict_dense(ref_hw, ref_gran, b))
        if cfg.ffn.kind == "moe":
            f = cfg.ffn
            assert _same(
                core.predict_moe_balanced(hw, gran, f.n_experts, f.top_k,
                                          f.d_ff, b),
                ref_core.predict_moe_balanced(ref_hw, ref_gran, f.n_experts,
                                              f.top_k, f.d_ff, b))
            assert _same(core.predict_moe_skewed(hw, gran, f.top_k, f.d_ff,
                                                 b),
                         ref_core.predict_moe_skewed(ref_hw, ref_gran,
                                                     f.top_k, f.d_ff, b))
            for n in (1, 16, 64):
                assert core.ai_moe(n, b, f.top_k, f.n_experts, f.d_ff) == \
                    ref_core.ai_moe(n, b, f.top_k, f.n_experts, f.d_ff)
        for n in (1, 16, 64):
            assert core.ai_dense(n, b) == ref_core.ai_dense(n, b)
    for ell in (64, 147, 512, 4096):
        assert core.ai_attn(16, ell) == ref_core.ai_attn(16, ell)
        assert core.n_idle_attn(hw.rho, ell) == \
            ref_core.n_idle_attn(ref_hw.rho, ell)


G256 = core.GranularitySpec.for_backend(n_experts=256)
REF_G256 = ref_core.GranularitySpec.for_backend(n_experts=256)


# the reference's Table 24 cases (tests/test_nfp_core.py): the call, then
# the paper's value of each
TABLE_24 = {
    "dense_h20_b1": (lambda m, g, hw: m.predict_dense(hw["h20"], g, b=1),
                     lambda p: round(p.n_max) == 37 and round(p.n_idle) == 37),
    "dense_h20_b4": (lambda m, g, hw: m.predict_dense(hw["h20"], g, b=4),
                     lambda p: round(p.n_max) == 9),
    "dense_a800": (lambda m, g, hw: m.predict_dense(hw["a800"], g, b=1),
                   lambda p: p.n_max == 64 and p.limiting == "attn_tile"
                   and round(p.n_idle) == 153
                   and 2.3 < p.overprediction < 2.5),
    "dense_h800": (lambda m, g, hw: m.predict_dense(hw["h800"], g, b=1),
                   lambda p: p.n_max == 64 and round(p.n_idle) == 295),
    "moe_balanced_23x": (
        lambda m, g, hw: m.predict_moe_balanced(hw["h20"], g, n_experts=256,
                                                k=8, d_ff=512),
        lambda p: p.n_max == 64 and 22 < p.overprediction < 24),
    "moe_balanced_k32": (
        lambda m, g, hw: m.predict_moe_balanced(hw["h20"], g, n_experts=256,
                                                k=32, d_ff=512),
        lambda p: p.n_max == 64 and 5.3 < p.overprediction < 6.0),
    "moe_skewed": (
        lambda m, g, hw: m.predict_moe_skewed(hw["h20"], g, k=8, d_ff=512),
        lambda p: p.n_max == 16 and 2.5 < p.overprediction < 3.1),
}


@pytest.mark.parametrize("case", sorted(TABLE_24))
def test_paper_table_24_cases(case):
    call, paper = TABLE_24[case]
    hw = {n: core.get_hardware(n) for n in GPUS}
    ref_hw = {n: ref_core.get_hardware(n) for n in GPUS[:3]}
    got = call(core, G256, hw)
    assert _same(got, call(ref_core, REF_G256, ref_hw))
    assert paper(got)


def test_skewed_idle_is_nearly_constant_across_k():
    """The paper's skewed idle prediction (~45 at H20) barely moves with
    k: the reference's check, on the port's ``n_idle_moe``."""
    vals = [core.n_idle_moe(core.H20.rho, 1, k, e_act=k, d_ff=512)
            for k in (2, 8, 32, 128)]
    assert max(vals) / min(vals) < 1.6
    assert vals == [ref_core.n_idle_moe(ref_core.H20.rho, 1, k, e_act=k,
                                        d_ff=512) for k in (2, 8, 32, 128)]


@pytest.mark.parametrize("reduced", (False, True))
def test_all_configs_equals_the_references(reduced):
    port, ref = all_configs(reduced), ref_all_configs(reduced)
    assert list(port) == list(ref)
    assert [c.name for c in port.values()] == [c.name for c in ref.values()]
    assert set(port) | set(PAPER_IDS) == set(ARCH_IDS)


def test_core_reexports_the_references_public_names():
    """Every name the reference's ``repro.core`` exports, less its TPU
    preset, and the H100."""
    want = {n for n in ref_core.__all__ if n != "TPU_V5E"} | {"H100"}
    assert want <= set(core.__all__)


@pytest.mark.parametrize("arch", ("stablelm_3b", "minicpm3_4b",
                                  "wedlm8b_like"))
def test_init_paged_kv_cache_has_the_references_shapes(arch):
    a = get_config(arch, reduced=True).attention
    ref_a = ref_config(arch, reduced=True).attention
    got = init_paged_kv_cache(9, 16, a, torch.float32)
    want = ref_init_paged(9, 16, ref_a, jnp.float32)
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert not got[k].any()
    stacked = init_paged_kv_cache(9, 16, a, lead=(3,))
    assert tuple(stacked[next(iter(got))].shape) == \
        (3,) + tuple(want[next(iter(got))].shape)


@pytest.mark.parametrize("window", (None, 24))
@pytest.mark.parametrize("n", (1, 5))
def test_aligned_decode_attention_equals_the_references(n, window):
    """Every row at ``total_len - n``: GQA (8 q / 2 kv heads), f32."""
    rng = np.random.default_rng(10 + n)
    b, h, kv, dh, s, total = 3, 8, 2, 16, 96, 61
    q = rng.standard_normal((b, n, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), total, window=window,
                                    interpret=True)
    got = ops.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), total, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _public_defs(path: Path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


# reference modules whose counterpart has another name (the Pallas
# kernels and their references became csrc/ sources and ops' plain
# versions; the analyzer's Pallas and recompile checks became the CUDA
# launch contracts and the recapture check)
RENAMED = {"analysis/pallas_contracts.py": "analysis/kernel_contracts.py",
           "analysis/recompile.py": "analysis/recapture.py"}


def test_every_public_name_of_the_reference_has_a_counterpart():
    """Name by name, each reference module's top-level public ``def`` /
    ``class`` is in its port counterpart (the Pallas kernel modules
    aside: their functions are the CUDA sources')."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = {}
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        if rel.startswith("kernels/") and rel.endswith(("/kernel.py",
                                                        "/ref.py")):
            continue
        if rel in RENAMED:
            continue
        gone = _public_defs(f) - _public_defs(port / rel)
        if gone:
            missing[rel] = sorted(gone)
    assert not missing
