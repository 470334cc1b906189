"""The port stands alone: it never imports jax or the JAX package (serving,
training with failover, a scenario of the fleet, an example and every public
name), and it calls no library attention kernel and no torch.compile."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_runs_without_jax_in_sys_modules():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.launch.serve import main\n"
        "main(['--device', 'cpu', '--smoke', '--batch', '2', '--prompt-len', '6', "
        "'--gen', '3'])\n"
        "main(['--arch', 'mamba2-2.7b', '--device', 'cpu', '--smoke', '--batch', '2', "
        "'--prompt-len', '11', '--gen', '4'])\n"
        "from repro_torch.launch import train\n"
        "train.main(['--device', 'cpu', '--smoke', '--steps', '4', '--inject-failure', '2'])\n"
        "import tempfile\n"
        "from repro_torch.runtime.scenarios import corpus\n"
        "v = repro_torch.run_scenario(corpus()[0], tempfile.mkdtemp(), device='cpu')\n"
        "print('scenario', v.name, v.recoveries, v.rollbacks, v.detections)\n"
        "from repro_torch.examples import elastic_rescale\n"
        "elastic_rescale.main(['--device', 'cpu'])\n"
        "for name in repro_torch.__all__:\n"
        "    getattr(repro_torch, name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED" in proc.stdout and "decoded 3 tokens/seq" in proc.stdout
    assert "prefill: 2x11" in proc.stdout and "decoded 4 tokens/seq" in proc.stdout
    assert "recovered from neighbor (stream policy)" in proc.stdout
    assert "done: 4 iterations" in proc.stdout
    assert "scenario clean_software_failure 1 0 1" in proc.stdout
    assert "exact-cover data partition preserved after rescale — OK" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_no_library_attention_or_compile_in_the_port():
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile",
                       "flash_attn", "xformers"):
            assert banned not in text, f"{path.relative_to(ROOT)} uses {banned}"


def test_kernel_sources_ship_with_the_package():
    from repro_torch.kernels import _build
    names = {p.name for p in _build._sources()}
    assert names == {"flash_attention.cu", "flash_attention_wgmma.cu", "decode_attn.cu",
                     "ssd.cu", "ssd_wgmma.cu"}
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"   # git-ignored
    assert _build.library_path().name.startswith("librepro_torch_kernels_")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_simlint_rules_hold_in_the_port():
    """simlint's determinism rules (SIM001-SIM007) are scoped to
    ``src/repro/``: run its engine on every file of the port as if it lived
    at the same place in the reference, which the port's layout mirrors.
    SIM008 pins the reference's public API and is left out."""
    sys.path.insert(0, str(ROOT))
    from tools.simlint import default_rules, lint_text
    rules = [r for r in default_rules() if r.code != "SIM008"]
    found = []
    for path in sorted(PORT.rglob("*.py")):
        rel = "src/repro/" + path.relative_to(PORT).as_posix()
        found += [f"{path.relative_to(ROOT)}:{f.line}: {f.code} {f.message}"
                  for f in lint_text(path.read_text(), rel, rules)]
    assert not found, "\n".join(found)
