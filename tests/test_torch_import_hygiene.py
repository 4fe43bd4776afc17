"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``paddle_tpu``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    __import__(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(len([n for n in sys.modules if n.startswith("paddle_tpu_torch")]))
print(bad)
print(sorted(n for n in sys.modules if n.count(".") == 1
             and n.startswith("paddle_tpu_torch.")))
sys.exit(1 if bad else 0)
"""
# the training slice's modules, besides the served slice's
_TRAINING = ("amp", "optimizer", "observability", "regularizer")


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


def test_import_pulls_in_no_jax_and_no_reference():
    # a fresh interpreter: this process already holds jax (conftest)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules, bad, top = res.stdout.split("\n")[:3]
    assert int(n_modules) >= 20 and bad == "[]"
    for name in _TRAINING:
        assert f"'paddle_tpu_torch.{name}'" in top, (name, top)


def test_no_file_imports_jax_or_reference():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert len(files) > 20
    assert not offenders, offenders
