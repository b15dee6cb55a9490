"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, CPU tensors never
reach a CUDA kernel, and asking for CUDA where there is none raises
instead of carrying on on the CPU."""
from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imports(path) if FORBIDDEN.match(m)]
    assert not bad, f"{path.name} imports {bad}"
    line_re = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    assert not [ln for ln in path.read_text().splitlines()
                if line_re.match(ln)]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_runs_with_jax_unimportable():
    """Import every port module and serve two requests on the CPU in a
    process where ``import jax`` fails."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.launch.serve import build_parser, serve\n"
        "serve(build_parser().parse_args(['--device', 'cpu', '--tiny', "
        "'--requests', '2', '--slots', '2', '--tokens', '3']))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 2 requests" in proc.stdout


def test_cpu_wrapper_calls_do_not_count_launches():
    from repro_torch.kernels.decode_attention import ops
    ops.decode_attention_ragged.launches = 0
    ops.decode_attention_paged.launches = 0
    q = torch.randn(2, 3, 4, 16)
    k = torch.randn(2, 32, 4, 16)
    ops.decode_attention_ragged(q, k, k, torch.tensor([0, 20]))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pool = torch.randn(5, 16, 4, 16)
    ops.decode_attention_paged(q, pool, pool, torch.tensor([4, 9]), tables)
    assert ops.decode_attention_ragged.launches == 0
    assert ops.decode_attention_paged.launches == 0


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


def test_default_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serving import DecodeEngine
    cfg = get_config("stablelm_3b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg, torch.Generator())
    params = init_model(cfg, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(cfg, params, batch=2, max_len=64)
    eng = DecodeEngine(cfg, params, batch=2, max_len=64, device="cpu")
    assert eng.use_kernel is False


def test_chip_smoke_fails_without_cuda_and_without_the_repo(no_cuda,
                                                            tmp_path):
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
