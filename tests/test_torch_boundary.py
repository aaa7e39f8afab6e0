"""The port's boundary: repro_torch and chip_smoke.py stand without JAX.

The port installs without JAX: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the ``repro`` package (only tests
import both), and the smoke script refuses to run without a card.
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:\.|\s|,|$)"
    r"|from\s+(?:jax|repro)(?:\.|\s))", re.M)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(bad)); print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import dpf", "import repro",
                 "    from repro import engine"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import dpf",
                 "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
