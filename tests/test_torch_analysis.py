"""The port's hot-path analyzer ``repro_torch.analysis``: fixture-driven
checker behaviour (every host-sync family flagged, clean idioms silent,
only the hot path checked, pragmas honoured; recapture hazards and the
bucket / width-table cleansers; the ctypes signatures against the
``extern "C"`` lists; launched tiles against the kernels' limits; drift,
never suppressible), the baseline mechanics and the CLI's exit codes,
then the real tree: its committed baseline, its launches at the twelve
configs' shapes, the pinned contract against the reference's (read as
JSON), and the four kernel wrappers passing their entry points exactly
what their launch-args functions return (on the CPU, through a fake
library, with the launch recorder installed).

Fixture projects are tiny tmp_path packages parsed by the AST index; the
real tree's index is built once per module (~3 s)."""
from __future__ import annotations

import ctypes
import json
import textwrap
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (Project, diff_against_baseline,  # noqa: E402
                                  load_baseline, run_checkers,
                                  write_baseline)
from repro_torch.analysis import granularity_drift as gd  # noqa: E402
from repro_torch.analysis import host_sync, recapture  # noqa: E402
from repro_torch.analysis import kernel_contracts as kc  # noqa: E402
from repro_torch.analysis.cli import BASELINE_REL, main  # noqa: E402
from repro_torch.analysis.findings import Finding  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ===========================================================================
# fixture projects
# ===========================================================================

def make_project(tmp_path, **modules) -> Project:
    src = tmp_path / "src"
    pkg = src / "pkg"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for name, code in modules.items():
        (pkg / f"{name}.py").write_text(textwrap.dedent(code))
    return Project(src, rel_to=tmp_path, package="pkg")


LOOP_HEAD = '''
    import numpy as np
    import torch

    def model_step(x: torch.Tensor) -> torch.Tensor:
        return x + 1

    class Loop:
        def __init__(self):
            self.state = torch.zeros((4,))

        def step(self, ys, idx, r):
            y = model_step(self.state)
'''

BAD_LOOP = LOOP_HEAD + '''
            n = int(y[0])
            host = np.asarray(y)
            vals = y.tolist()
            acc = 0.0
            for v in y:
                acc += 1.0
            torch.cuda.synchronize()
            picked = y[y > 0]
            return n, host, vals, acc, picked
'''

CLEAN_LOOP = LOOP_HEAD + '''
            self.state = y
            width = y.shape[0]
            meta = (y.size(0), y.numel(), y.dtype, y.device, y.data_ptr())
            host_tokens = np.zeros((width,), np.int32)
            up = torch.as_tensor(host_tokens, device=y.device)
            if self.state is None or not host_tokens.any():
                width += 1
            for a, b in zip([y, y], [up, up]):
                width += a.dim()
            kept = torch.where(y > 0, y, 0.0)
            return width, meta, kept
'''

PRAGMA_LOOP = LOOP_HEAD + '''
            sanctioned = y.cpu().numpy()  # analysis: allow-hs002
            bad = y.cpu()
            return sanctioned, bad
'''

FIXTURE_ROOTS = ("pkg.loop.Loop.step",)
ALL_HS = {"HS001", "HS002", "HS003", "HS004", "HS005", "HS006"}

# one line of each family (and each spelling) of a host sync
SYNC_LINES = [
    ("HS001", "v = int(y[0])"),
    ("HS001", "v = float(y.sum())"),
    ("HS001", "v = bool(y.any())"),
    ("HS001", "v = 1 if y.any() else 0"),
    ("HS001", "while y.max() > 3:\n    y = y - 1"),
    ("HS001", "assert y.all()"),
    ("HS002", "v = np.asarray(y)"),
    ("HS002", "v = np.array(y)"),
    ("HS002", "v = y.cpu()"),
    ("HS002", "v = y.numpy()"),
    ("HS002", "v = y.to('cpu')"),
    ("HS002", "v = y.to(device=torch.device('cpu'))"),
    ("HS003", "v = y.item()"),
    ("HS003", "v = y.tolist()"),
    ("HS004", "for v in y:\n    pass"),
    ("HS004", "v = [a for a in y]"),
    ("HS004", "v = sorted(y)"),
    ("HS005", "torch.cuda.synchronize()"),
    ("HS005", "torch.cuda.current_stream().synchronize()"),
    ("HS006", "v = torch.nonzero(y)"),
    ("HS006", "v = y.nonzero()"),
    ("HS006", "v = torch.where(y > 0)"),
    ("HS006", "v = torch.bincount(y.long())"),
    ("HS006", "v = y.unique()"),
    ("HS006", "v = torch.masked_select(y, y > 0)"),
    ("HS006", "v = y.repeat_interleave(y.long())"),
    ("HS006", "v = y[y > 0]"),
    ("HS006", "m = (y > 0) & (y < 3)\nv = y[m]"),
    ("HS001", "lin = torch.nn.Linear(4, 4)\nv = int(lin(r))"),
]

# idioms that read nothing back
CLEAN_LINES = [
    "v = y.repeat_interleave(2, dim=0)",
    "v = y.repeat_interleave(y.long(), output_size=8)",
    "v = torch.where(y > 0, y, 0.0)",
    "v = y[idx.long()]",
    "v = y.masked_fill(y > 0, 0.0)",
    "v = y.shape[0] + y.size(0) + y.numel() + y.dim()",
    "v = (y.dtype, y.device, y.data_ptr(), y.stride(), y.is_contiguous())",
    "v = torch.as_tensor(np.zeros(3), device=y.device)",
    "if y is None or r in ys:\n    pass",
    "for t in [y, y]:\n    t.add_(1)",
    "for a, b in zip(ys, ys):\n    a.add_(b)",
    "for k, t in {'a': y}.items():\n    t.add_(1)",
    "v = len(y)",
    "v = int(r) + float(len(ys))",
]


def _step_project(tmp_path, line: str) -> Project:
    body = textwrap.indent(textwrap.dedent(line), " " * 12)
    return make_project(tmp_path, loop=LOOP_HEAD + body + "\n")


# ===========================================================================
# checker 1: host-sync
# ===========================================================================

def test_host_sync_flags_every_sync_family(tmp_path):
    project = make_project(tmp_path, loop=BAD_LOOP)
    findings = host_sync.check(project, roots=FIXTURE_ROOTS)
    rules = {f.rule for f in findings}
    assert rules == ALL_HS
    assert all(f.path == "src/pkg/loop.py" for f in findings)
    assert all(f.symbol == "pkg.loop.Loop.step" for f in findings)


@pytest.mark.parametrize("rule,line", SYNC_LINES,
                         ids=[f"{r}:{ln.split(chr(10))[0]}"
                              for r, ln in SYNC_LINES])
def test_host_sync_flags_each_spelling(tmp_path, rule, line):
    findings = host_sync.check(_step_project(tmp_path, line),
                               roots=FIXTURE_ROOTS)
    assert [f.rule for f in findings] == [rule], [f.render()
                                                  for f in findings]


@pytest.mark.parametrize("line", CLEAN_LINES)
def test_host_sync_clean_idioms_are_silent(tmp_path, line):
    findings = host_sync.check(_step_project(tmp_path, line),
                               roots=FIXTURE_ROOTS)
    assert findings == [], [f.render() for f in findings]


def test_host_sync_clean_loop_zero_false_positives(tmp_path):
    project = make_project(tmp_path, loop=CLEAN_LOOP)
    assert host_sync.check(project, roots=FIXTURE_ROOTS) == []


def test_host_sync_only_hot_path_is_checked(tmp_path):
    """The same sync outside the reachable set is not the hot path's
    problem — reachability, not a whole-tree grep."""
    project = make_project(tmp_path, loop=CLEAN_LOOP, offline=BAD_LOOP)
    assert host_sync.check(project, roots=FIXTURE_ROOTS) == []
    via_offline = host_sync.check(project, roots=("pkg.offline.Loop.step",))
    assert {f.rule for f in via_offline} == ALL_HS


def test_host_sync_pragma_suppresses_sanctioned_line(tmp_path):
    project = make_project(tmp_path, loop=PRAGMA_LOOP)
    findings = host_sync.check(project, roots=FIXTURE_ROOTS)
    assert len(findings) == 1
    (f,) = findings
    assert f.rule == "HS002" and "bad = " not in f.snippet
    src = (tmp_path / "src/pkg/loop.py").read_text()
    bad_line = next(i for i, t in enumerate(src.splitlines(), 1)
                    if t.strip().startswith("bad ="))
    assert f.line == bad_line


def test_host_sync_reaches_closures_and_subclass_overrides(tmp_path):
    """A nested def is indexed (a closure can be a root) and reachable
    from its enclosing def; ``self.method()`` reaches the subclasses'
    overrides."""
    project = make_project(tmp_path, loop='''
        import torch

        def make_step():
            def step(x: torch.Tensor):
                return x.item()
            return step

        class Base:
            def run(self, x):
                return self.pull(x)

            def pull(self, x):
                return x

        class Child(Base):
            def pull(self, x: torch.Tensor):
                return x.tolist()
    ''')
    assert [f.symbol for f in host_sync.check(
        project, roots=("pkg.loop.make_step",))] == [
        "pkg.loop.make_step.step"]
    assert [f.symbol for f in host_sync.check(
        project, roots=("pkg.loop.Base.run",))] == ["pkg.loop.Child.pull"]


# ===========================================================================
# checker 2: recapture hazards
# ===========================================================================

CAPTURE = '''
    class DecodeGraphs:
        def warm(self, shape, use_kernel):
            return shape

        def replay(self, tokens, use_kernel):
            return self.warm(tokens.shape, use_kernel)

    class DecodeEngine:
        def decode_slots(self, tokens):
            return tokens

        def warm_decode(self, widths):
            return widths
'''

BAD_HAZARD = '''
    import numpy as np
    import torch

    def serve(graphs, engine, prompts):
        outs = []
        for p in prompts:
            g = torch.cuda.CUDAGraph()
            fn = torch.compile(lambda x: x + 1)
            n = len(p)
            graphs.warm((4, n), True)
            toks = np.zeros((4, n), np.int64)
            outs.append(engine.decode_slots(torch.as_tensor(toks)))
        return outs, g, fn
'''

CLEAN_HAZARD = '''
    import numpy as np
    import torch

    @torch.compile
    def fused(x):
        return x + 1

    def prefill_bucket(n):
        w = 8
        while w < n:
            w *= 2
        return w

    def serve(graphs, engine, adapter, prompts, budget, slots):
        outs = []
        for p in prompts:
            width = adapter.width(len(slots), budget)
            graphs.warm((4, prefill_bucket(len(p))), True)
            toks = np.zeros((4, width), np.int64)
            outs.append(engine.decode_slots(torch.as_tensor(toks)))
        engine.warm_decode(range(1, 17))
        return outs
'''


def test_recapture_flags_graph_in_body_and_shape_derived_widths(tmp_path):
    project = make_project(tmp_path, capture=CAPTURE, hazard=BAD_HAZARD)
    findings = recapture.check(project, capture_modules=("pkg.capture",))
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert set(by_rule) == {"RC001", "RC002", "RC003"}
    assert {f.snippet.split("(")[0] for f in by_rule["RC001"]} == {
        "torch.cuda.CUDAGraph", "torch.compile"}
    assert "shape" in by_rule["RC002"][0].message
    assert "tokens" in by_rule["RC003"][0].message
    assert all(f.path == "src/pkg/hazard.py" for f in findings)


def test_recapture_bucket_and_width_table_cleanse_shape_taint(tmp_path):
    """prefill_bucket(len(p)) and the adapter's width(len(slots), budget)
    are the sanctioned launderings of a runtime length into a small
    graph set; a module-scope ``@torch.compile`` is built once."""
    project = make_project(tmp_path, capture=CAPTURE, hazard=CLEAN_HAZARD)
    assert recapture.check(project, capture_modules=("pkg.capture",)) == []


def test_recapture_capture_path_may_build_graphs(tmp_path):
    code = '''
        import torch

        class DecodeGraphs:
            def _capture(self):
                return torch.cuda.CUDAGraph()
    '''
    project = make_project(tmp_path, capture=code)
    assert recapture.check(project, capture_modules=("pkg.capture",)) == []
    assert [f.rule for f in recapture.check(project, capture_modules=())
            ] == ["RC001"]


# ===========================================================================
# checker 3: kernel launch contracts
# ===========================================================================

@pytest.fixture(scope="module")
def sources():
    return kc.read_sources()


@pytest.fixture(scope="module")
def exts(sources):
    return {e: kc.extern_signatures(sources[cu])[e]
            for e, (cu, _) in kc.ENTRY_POINTS.items()}


def test_signatures_equal_the_extern_c_lists(sources, exts):
    """Each wrapper's ctypes argtypes are its entry point's parameter
    list, kind by kind."""
    declared = kc.declared_signatures()
    assert set(declared) == set(exts)
    for entry, argtypes in declared.items():
        assert tuple(kc.ctypes_kind(a) for a in argtypes) == \
            exts[entry].kinds, entry
    assert kc.check_signatures(sources) == []


@pytest.mark.parametrize("entry,param", [
    ("decode_attention_dense", "int s_max, "),
    ("decode_attention_paged", "float scale,"),
    ("moe_ffn", "int gated, "),
    ("mamba_scan", "const float* a, "),
])
def test_kc001_a_parameter_dropped_from_the_source(sources, entry, param):
    cu = kc.ENTRY_POINTS[entry][0]
    text = sources[cu]
    start = text.index(f'extern "C" int {entry}(')
    end = text.index(")", start)
    assert param in text[start:end]
    bad = dict(sources, **{cu: text[:start] + text[start:end].replace(
        param, "", 1) + text[end:]})
    findings = kc.check_signatures(bad)
    assert [(f.rule, f.symbol) for f in findings] == [("KC001", entry)]
    assert "extern" in findings[0].message


def test_kc001_a_parameter_dropped_from_the_ctypes_signature(sources):
    declared = kc.declared_signatures()
    declared["moe_ffn"] = declared["moe_ffn"][:-1]
    findings = kc.check_signatures(sources, declared)
    assert [(f.rule, f.symbol) for f in findings] == [("KC001", "moe_ffn")]


def test_kc001_a_launch_of_the_wrong_arity_or_kind(sources, exts):
    good = kc.config_launches(["stablelm_3b"], sources)[0]
    short = kc.LaunchRecord(good.entry, good.args[:-1], "short")
    wrong = kc.LaunchRecord(good.entry, good.args[:5] + (kc.PTR,)
                            + good.args[6:], "wrong")
    findings = kc.check_launches([good, short, wrong], sources)
    assert [(f.rule, f.symbol.split("[")[1]) for f in findings] == [
        ("KC001", "short]"), ("KC001", "wrong]")]


BAD_TILES = [
    ("decode_attention_dense", {"q_block": 24}, "q tile"),
    ("decode_attention_dense", {"k_block": 256}, "kMaxKBlock"),
    ("decode_attention_dense", {"dh": 144}, "kMaxDh"),
    ("decode_attention_dense", {"kv": 5}, "group"),
    ("decode_attention_paged", {"block_size": 0}, "kMaxKBlock"),
    ("decode_attention_paged", {"window": 0}, "window"),
    ("decode_attention_paged", {"span": 0}, "kMaxSpan"),
    ("decode_attention_dense", {"span": 3}, "kMaxSpan"),
    ("moe_ffn", {"token_block": 8}, "16-row"),
    ("moe_ffn", {"m_pad": 72}, "divide"),
    ("moe_ffn", {"f": 1000}, "512"),
    ("mamba_scan", {"s_pad": 17}, "kSteps"),
    ("mamba_scan", {"ds": 65}, "kMaxState"),
]


def _launch(entry, exts, sources, **scalars):
    cfg = {"moe_ffn": "granite_moe_3b_a800m",
           "mamba_scan": "falcon_mamba_7b"}.get(entry, "stablelm_3b")
    base = next(r for r in kc.config_launches([cfg], sources)
                if r.entry == entry)
    v = dict(base.scalars(exts[entry]), **scalars)
    return kc.synthetic(entry, tuple(v.values()), exts[entry], "fixture")


@pytest.mark.parametrize("entry,change,words", BAD_TILES,
                         ids=[f"{e}:{next(iter(c))}" for e, c, _ in BAD_TILES])
def test_kc002_a_bad_tile(sources, exts, entry, change, words):
    assert kc.check_launches([_launch(entry, exts, sources)], sources) == []
    findings = kc.check_launches([_launch(entry, exts, sources, **change)],
                                 sources)
    assert [f.rule for f in findings] == ["KC002"]
    assert words in findings[0].message


def test_kc002_limits_come_from_the_kernels_constexprs(sources, exts):
    bigger = dict(sources, decode_attention=sources[
        "decode_attention"].replace("kMaxKBlock = 128", "kMaxKBlock = 256"))
    # one 256-position tile covers the 256-position cache: a span of one
    launch = _launch("decode_attention_dense", exts, sources, k_block=256,
                     span=1)
    assert kc.check_launches([launch], bigger) == []


def test_kc003_recorded_scalars_against_the_launch_args_functions(
        sources, exts):
    """A recorded launch must carry what the launch-args function gives
    at its shapes, at the served model's geometry; MoE records get their
    token count."""
    from repro_torch.configs import get_config
    granite = get_config("granite_moe_3b_a800m")
    stablelm = get_config("stablelm_3b")
    good = kc.config_launches(["granite_moe_3b_a800m"], sources)
    tokens = [r.tokens for r in good]
    for r in good:
        r.label, r.tokens, r.experts = "granite", None, None
    configs = {"granite": granite, "stablelm": stablelm}
    assert kc.check_recorded(good, configs, sources) == []
    for r, t in zip(good, tokens):
        if r.entry == "moe_ffn":
            # the fewest tokens giving this launch, in the same regime
            assert r.experts == 40 and r.tokens <= t
            assert (r.tokens <= 40) == (t <= 40)
            assert kc.moe_scalars(granite, r.tokens) == \
                kc.moe_scalars(granite, t)
    bad = [_launch("decode_attention_dense", exts, sources, q_block=32),
           _launch("decode_attention_dense", exts, sources),
           _launch("mamba_scan", exts, sources, s_pad=48, bsz=3),
           _launch("moe_ffn", exts, sources, m_pad=16 * 400)]
    for r in bad:
        r.label = "granite"
    findings = [f for f in kc.check_recorded(bad, configs, sources)
                if f.rule == "KC003"]
    assert [f.symbol.split("[")[0] for f in findings] == [
        "decode_attention_dense", "decode_attention_dense", "mamba_scan",
        "moe_ffn"]
    assert "launch-args" in findings[0].message           # q_block 32
    assert "(h, kv, dh, window)" in findings[1].message   # not granite's
    assert "no Mamba1 layer" in findings[2].message
    assert "no token count" in findings[3].message


# ===========================================================================
# checker 4: granularity drift
# ===========================================================================

_TILES = {"m_attn_decode": 64, "k_block": 128}
_LAUNCHED = {k: {v} for k, v in _TILES.items()}
_EMULATION = {"KV_CHUNK/kChunk": (16, 16)}


def _drift(contract, declared=None, launched=None, emulation=None):
    return gd.check_drift(contract, declared=dict(declared or _TILES),
                          launched=launched or _LAUNCHED,
                          emulation=emulation or _EMULATION)


def test_drift_clean_when_all_three_agree():
    assert _drift(dict(_TILES)) == []


def test_drift_declared_vs_contract_is_gd001():
    declared = dict(_TILES, m_attn_decode=32)
    findings = _drift(dict(_TILES), declared,
                      {k: {v} for k, v in declared.items()})
    assert [f.rule for f in findings] == ["GD001"]
    assert findings[0].symbol == "m_attn_decode"


def test_drift_launched_vs_declared_is_gd002():
    findings = _drift(dict(_TILES),
                      launched=dict(_LAUNCHED, k_block={128, 256}))
    assert [f.rule for f in findings] == ["GD002"]
    assert findings[0].symbol == "k_block" and "[256]" in findings[0].message


def test_drift_unpinned_knob_is_gd003():
    findings = _drift({})
    assert {f.rule for f in findings} == {"GD003"}
    assert len(findings) == len(_TILES)


def test_drift_emulation_off_the_kernel_is_gd004():
    findings = _drift(dict(_TILES), emulation={"KV_CHUNK/kChunk": (16, 32)})
    assert [(f.rule, f.symbol) for f in findings] == [
        ("GD004", "KV_CHUNK/kChunk")]


def test_drift_findings_are_never_baseline_suppressible():
    findings = _drift(dict(_TILES), dict(_TILES, m_attn_decode=32),
                      emulation={"KV_CHUNK/kChunk": (16, 32)})
    assert {f.rule for f in findings} == {"GD001", "GD002", "GD004"}
    bl = {"suppressions": {f.fingerprint: {"count": 99} for f in findings}}
    new, suppressed, _ = diff_against_baseline(findings, bl)
    assert new == findings and suppressed == []


# ===========================================================================
# baseline mechanics
# ===========================================================================

def _finding(line=3, snippet="int(y)"):
    return Finding("host-sync", "HS001", "src/pkg/loop.py", line,
                   "pkg.loop.Loop.step", "msg", snippet)


def test_fingerprint_is_line_number_independent():
    assert _finding(line=3).fingerprint == _finding(line=99).fingerprint
    assert (_finding(snippet="int(y)").fingerprint
            != _finding(snippet="int(z)").fingerprint)


def test_baseline_roundtrip_suppresses_known_debt(tmp_path):
    path = tmp_path / "analysis-baseline.json"
    write_baseline(path, [_finding()], {"m_attn_decode": 64})
    bl = load_baseline(path)
    assert bl["granularity_contract"] == {"m_attn_decode": 64}
    new, suppressed, stale = diff_against_baseline([_finding(line=7)], bl)
    assert new == [] and len(suppressed) == 1 and stale == []


def test_baseline_counts_gate_duplicate_snippets(tmp_path):
    path = tmp_path / "analysis-baseline.json"
    write_baseline(path, [_finding()], {})
    bl = load_baseline(path)
    new, suppressed, _ = diff_against_baseline(
        [_finding(line=3), _finding(line=9)], bl)
    assert len(suppressed) == 1 and len(new) == 1


def test_baseline_reports_stale_entries_when_debt_is_fixed(tmp_path):
    path = tmp_path / "analysis-baseline.json"
    write_baseline(path, [_finding()], {})
    _, _, stale = diff_against_baseline([], load_baseline(path))
    assert len(stale) == 1 and stale[0]["rule"] == "HS001"


# ===========================================================================
# CLI gate on fixture trees
# ===========================================================================

def _fixture_repo(tmp_path, step_body: str) -> Path:
    """A tree holding ``src/repro_torch/serving/scheduler.py`` whose
    ``ServingLoop.step`` (a default root) runs ``step_body``."""
    pkg = tmp_path / "src" / "repro_torch" / "serving"
    pkg.mkdir(parents=True)
    for d in (pkg.parent, pkg):
        (d / "__init__.py").write_text("")
    (pkg / "scheduler.py").write_text(textwrap.dedent('''
        import torch

        class ServingLoop:
            def __init__(self):
                self.logits = torch.zeros((4,))

            def step(self):
                x = self.logits.argmax()
    ''') + textwrap.indent(step_body, " " * 8) + "\n")
    return tmp_path


AST_CHECKERS = ["--checkers", "host-sync,recapture-hazard"]


def test_cli_check_baseline_fails_on_bad_fixture_tree(tmp_path, capsys):
    root = _fixture_repo(tmp_path, "return x.item()")
    rc = main(["--root", str(root), *AST_CHECKERS, "--check-baseline"])
    assert rc == 2
    captured = capsys.readouterr()
    assert "FAIL" in captured.err and "HS003" in captured.out


def test_cli_check_baseline_passes_on_clean_fixture_tree(tmp_path, capsys):
    root = _fixture_repo(tmp_path, "return x")
    rc = main(["--root", str(root), *AST_CHECKERS, "--check-baseline"])
    assert rc == 0
    assert "0 new" in capsys.readouterr().out


def test_cli_json_output_is_machine_readable(tmp_path, capsys):
    root = _fixture_repo(tmp_path, "return int(x), x.cpu()")
    rc = main(["--root", str(root), "--checkers", "host-sync", "--json"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in data["findings"]} == {"HS001", "HS002"}
    assert all(f["fingerprint"] for f in data["findings"])


@pytest.mark.parametrize("argv", [["--checkers", "nope"],
                                  ["--checkers", "host-sync,pallas-contract"]])
def test_cli_usage_errors_exit_1(argv, capsys):
    assert main(argv) == 1
    assert "error" in capsys.readouterr().err


def test_cli_write_baseline_then_check_passes(tmp_path, capsys):
    root = _fixture_repo(tmp_path, "return x.item()")
    bl = tmp_path / "bl.json"
    argv = ["--root", str(root), *AST_CHECKERS, "--baseline", str(bl)]
    assert main(argv + ["--write-baseline"]) == 0
    assert main(argv + ["--check-baseline"]) == 0
    assert load_baseline(bl)["suppressions"]


# ===========================================================================
# the real tree
# ===========================================================================

@pytest.fixture(scope="module")
def tree_project():
    return Project(ROOT / "src", rel_to=ROOT)


@pytest.fixture(scope="module")
def tree_launches(sources):
    return kc.config_launches(sources=sources)


def test_committed_baseline_is_current(tree_project, tree_launches):
    """`python -m repro_torch.analysis --check-baseline` passes on this
    tree: no NEW findings, no stale suppressions."""
    bl = load_baseline(ROOT / BASELINE_REL)
    findings = run_checkers(ROOT / "src", rel_to=ROOT,
                            contract=bl["granularity_contract"],
                            records=tree_launches)
    new, _, stale = diff_against_baseline(findings, bl)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], stale
    assert BASELINE_REL.parent == Path("src/repro_torch/analysis")


def test_port_contract_equals_the_references(tmp_path):
    """The port pins the reference's tiles: its contract equals the
    ``granularity_contract`` of the reference's baseline, read as JSON."""
    ref = json.loads((ROOT / "analysis-baseline.json").read_text())
    port = load_baseline(ROOT / BASELINE_REL)
    assert port["granularity_contract"] == ref["granularity_contract"]
    assert port["granularity_contract"] == gd.declared_tiles()


def test_config_launches_satisfy_the_contracts(tree_launches, sources):
    from repro_torch.configs import ARCH_IDS
    labels = {r.label.split("/")[0] for r in tree_launches}
    assert labels == set(ARCH_IDS) - {"minicpm3_4b"}  # MLA: no kernel
    assert {r.entry for r in tree_launches} == set(kc.ENTRY_POINTS)
    findings = kc.check(records=tree_launches)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_launched_tiles_match_granularity_registry(tree_launches, sources):
    """The tiles the wrappers launch with at the twelve configs' shapes
    are the numbers core.granularity hands the NFP predictor, and the
    CPU emulation's constants are the kernels' constexprs."""
    declared = gd.declared_tiles()
    launched = gd.launched_tiles(tree_launches, sources)
    assert set(launched) == {"m_attn_decode", "m_moe_decode", "m_ssm",
                             "k_block"}
    for knob, got in launched.items():
        assert got == {declared[knob]}, knob
    assert all(a == b for a, b in gd.emulation_pairs(sources).values())


def test_one_sided_tile_change_fails_drift_check(tree_launches, sources):
    """Halving a declared tile WITHOUT updating the pinned contract (or
    the kernels) fails, un-suppressibly."""
    bl = load_baseline(ROOT / BASELINE_REL)
    declared = gd.declared_tiles()
    declared["m_attn_decode"] //= 2
    findings = gd.check_drift(bl["granularity_contract"], declared=declared,
                              launched=gd.launched_tiles(tree_launches,
                                                         sources))
    assert {f.rule for f in findings} == {"GD001", "GD002"}
    new, _, _ = diff_against_baseline(
        findings,
        {"suppressions": {f.fingerprint: {"count": 9} for f in findings}})
    assert new == findings


def test_hot_paths_hold_only_the_sanctioned_pulls(tree_project,
                                                  monkeypatch):
    """From the serving loop's step, the engine's decode, the train step
    and the AdamW update, the only host reads are the pragma-marked
    per-step pulls of the greedy / speculative, diffusion and MTP
    adapters; the train step and the update read nothing back."""
    assert host_sync.check(tree_project) == []
    monkeypatch.setattr(host_sync, "scan_pragmas", lambda source: {})
    findings = host_sync.check(tree_project)
    assert sorted((f.symbol.split(".", 2)[2], f.rule) for f in findings) == [
        ("algorithm.SlotAdapter.run_step", "HS002"),
        ("diffusion.pull_confidence", "HS002"),
        ("mtp.MTPSlotAdapter.propose_rows", "HS002")]
    train_roots = host_sync.DEFAULT_ROOTS[2:]
    hot = tree_project.reachable(train_roots)
    assert "repro_torch.training.optimizer.adamw_update" in hot
    assert host_sync.check(tree_project, roots=train_roots) == []


def test_recapture_clean_on_the_tree(tree_project):
    """Only the capture path builds graphs, and every width that reaches
    a captured step comes through the width table or a bucket."""
    assert recapture.check(tree_project) == []


# ---------------------------------------------------------------------------
# the wrappers pass exactly their launch-args functions' tuples
# ---------------------------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel path on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return t.contiguous().as_subclass(_FakeCuda)


class _FakeEntry:
    argtypes = None
    restype = None

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_kernels(monkeypatch):
    """Fake loaded libraries in ``kernels.build._loaded``, a fake stream,
    ``torch.empty`` that ignores the device, the wrappers' lengths taken
    as given and host counters."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as attn
    libs = {}
    for name in kc.LaunchRecorder.LIBRARIES:
        libs[name] = types.SimpleNamespace(**{
            e: _FakeEntry() for e, (cu, _) in kc.ENTRY_POINTS.items()
            if cu == name})
        monkeypatch.setitem(build._loaded, name, libs[name])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(attn, "row_lens", lambda lens, b, device: lens)
    monkeypatch.setattr(attn, "_arrivals", lambda device, n: real_empty(
        n, dtype=torch.int32).zero_())
    return libs


def _wrapper_calls(cfgs):
    """Call each wrapper at the configs' decode shapes with fake CUDA
    tensors; returns [(entry, expected scalars)] in call order."""
    from repro_torch.kernels.decode_attention import ops as attn
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.moe_ffn import ops as moe
    bf16 = torch.bfloat16
    want = []
    a = cfgs["stablelm"].attention
    b, n, s, page = 2, 3, 40, 16
    q = _cuda(torch.zeros(b, n, a.n_heads, a.head_dim, dtype=bf16))
    k = _cuda(torch.zeros(b, s, a.n_kv_heads, a.head_dim, dtype=bf16))
    lens = _cuda(torch.tensor([0, 9], dtype=torch.int32))
    attn.decode_attention_ragged(q, k, k, lens)
    want.append(("decode_attention_dense",
                 attn.dense_launch_args(q.shape, k.shape, None)))
    pool = _cuda(torch.zeros(7, page, a.n_kv_heads, a.head_dim, dtype=bf16))
    tables = _cuda(torch.zeros(b, 3, dtype=torch.int32))
    attn.decode_attention_paged(q, pool, pool, lens, tables, window=5)
    want.append(("decode_attention_paged",
                 attn.paged_launch_args(q.shape, pool.shape, tables.shape,
                                        5)))
    f, d = cfgs["granite"].ffn, 64
    tb, m_pad = 16, 48
    w_up = _cuda(torch.zeros(f.n_experts, d, 32, dtype=bf16))
    w_down = _cuda(torch.zeros(f.n_experts, 32, d, dtype=bf16))
    x = _cuda(torch.zeros(m_pad, d, dtype=bf16))
    meta = _cuda(torch.zeros(m_pad // tb, dtype=torch.int32))
    moe.grouped_ffn_padded(x, w_up, w_up, w_down, meta, meta,
                           token_block=tb, activation="swiglu")
    want.append(("moe_ffn", moe.launch_args(x.shape, w_up.shape, tb, True)))
    moe.grouped_ffn_padded(x, None, w_up, w_down, meta, meta,
                           token_block=tb, activation="gelu")
    want.append(("moe_ffn", moe.launch_args(x.shape, w_up.shape, tb,
                                            False)))
    ds = cfgs["falcon"].ssm.d_state
    xs = _cuda(torch.zeros(2, 32, 24))
    bc = _cuda(torch.zeros(2, 32, ds))
    scan.selective_scan_padded(xs, xs, bc, bc, _cuda(torch.zeros(24, ds)),
                               _cuda(torch.zeros(2, 24, ds)))
    want.append(("mamba_scan", scan.launch_args(xs.shape, (24, ds))))
    return want


@pytest.fixture(scope="module")
def small_cfgs():
    from repro_torch.configs import get_config
    return {"stablelm": get_config("stablelm_3b"),
            "granite": get_config("granite_moe_3b_a800m"),
            "falcon": get_config("falcon_mamba_7b")}


def test_wrappers_pass_exactly_their_launch_args(fake_kernels, small_cfgs,
                                                 exts):
    """Each wrapper hands its entry point the pointers, then exactly the
    tuple its launch-args function returns, then the tile counter and
    the stream; the arguments fit the ctypes signature it declares."""
    want = _wrapper_calls(small_cfgs)
    calls = {e: list(getattr(fake_kernels[cu], e).calls)
             for e, (cu, _) in kc.ENTRY_POINTS.items()}
    for entry, scalars in want:
        args = calls[entry].pop(0)
        ext = exts[entry]
        assert len(args) == len(ext.kinds)
        got = tuple(a for a, kind in zip(args, ext.kinds)
                    if kind != "pointer")
        assert got == scalars, entry
        assert args[-1] == 7                              # the stream
        argtypes = getattr(fake_kernels[kc.ENTRY_POINTS[entry][0]],
                           entry).argtypes
        assert [kc.ctypes_kind(t) for t in argtypes] == list(ext.kinds)
        for a, t in zip(args, argtypes):                  # ctypes accepts
            if a is not None and t is not ctypes.c_void_p:
                t(a)


def test_launch_recorder_records_what_the_wrappers_launch(
        fake_kernels, small_cfgs, sources):
    """Installed around the loaded libraries, the recorder keeps each
    launch's scalars with the pointers blanked, counts repeats, puts the
    libraries back on exit, and its records pass the on-card checks."""
    from repro_torch.kernels import build
    with kc.LaunchRecorder("fixture") as rec:
        want = _wrapper_calls(small_cfgs)
        _wrapper_calls(small_cfgs)
    assert build._loaded["moe_ffn"] is fake_kernels["moe_ffn"]
    records = rec.records()
    assert sum(r.count for r in records) == 2 * len(want)
    assert all(r.count == 2 and r.label == "fixture" for r in records)
    assert all(a in (kc.PTR, None) or isinstance(a, (int, float))
               for r in records for a in r.args)
    assert kc.distinct_configurations(records) == {
        "decode_attention_dense": 1, "decode_attention_paged": 1,
        "moe_ffn": 2, "mamba_scan": 1}
    assert kc.check_recorded(records, sources=sources) == []
