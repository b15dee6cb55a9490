"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the
program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from bench import harness

BENCH = harness.BENCH
ROOT = BENCH.parent

SCRIPT = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
sys.path = [p for p in sys.path if p not in ("", ".")]
from bench import harness
from bench.tests.conftest import TINY, tiny_serving
cell = harness.Cell("tiny", 1, dict(TINY["granite_moe_3b_a800m"]),
                    tiny_serving("granite_moe_3b_a800m"),
                    {{"served_logit_gap": 1.0}},
                    [{{"name": "decode_tok_s", "unit": "tokens/s"}}])
out = harness.execute(harness.Run(cell, 5, 3.0, True, 0.0, "cpu"))
import bench.calibrate
print(json.dumps({{"correct": out["correct"],
                  "forbidden": harness.forbidden_modules(),
                  "repro_torch": "repro_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax_and_no_repro():
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT / "bench"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": [], "repro_torch": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reproduce", sys)
    assert "reproduce" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.serving", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = harness.forbidden_modules()
    assert "repro.serving" in found and "jax.numpy" in found


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax", "flax"), (
                f.name, name)


def test_no_bench_module_imports_jax_or_repro():
    for f in BENCH.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)
