"""The PyTorch port and its chip smoke script import without JAX, Flax or
Optax."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / \
    "sbb_textline_detection_tpu_torch"
MODULES = sorted(
    "sbb_textline_detection_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent) + os.pathsep + env.get("PYTHONPATH",
                                                               "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(PKG.parent)))
def test_no_module_names_jax(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", src,
                         re.M), path
