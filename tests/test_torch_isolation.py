"""The port imports neither JAX nor the JAX package: an AST scan of its
sources, of chip_smoke.py and of examples/train_cnn_torch.py, and a
clean-interpreter import check."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "train_cnn_torch.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    pytest.importorskip("torch")
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.weights\n"
        "import repro_torch.kernels.ops, repro_torch.models\n"
        "import repro_torch.configs, repro_torch.serve.engine\n"
        "import repro_torch.models.api, repro_torch.models.transformer\n"
        "import repro_torch.tune, repro_torch.tune.__main__\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build.library.cache_info().currsize\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
