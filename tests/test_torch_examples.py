"""PyTorch port, the example scripts under ``examples/torch/``.

Each script, imported in a fresh interpreter, leaves no ``jax`` and no
``repro`` / ``repro.*`` module in ``sys.modules`` (the port imports neither);
the two that run in seconds on the CPU run to the end there.
"""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
SCRIPTS = sorted(p.name for p in EXAMPLES.glob("*.py"))
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))

_IMPORT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("example_under_test", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "repro" or m.startswith("repro."))
assert "repro_torch" in sys.modules, "the script does not import the port"
assert not bad, bad
print("clean")
"""


def test_the_seven_counterparts_exist():
    assert SCRIPTS == sorted(p.name for p in (REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("script", SCRIPTS)
def test_imports_neither_jax_nor_the_jax_package(script):
    res = subprocess.run([sys.executable, "-c", _IMPORT, str(EXAMPLES / script)],
                         capture_output=True, text=True, timeout=300, env=ENV, cwd=REPO)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-3000:]


@pytest.mark.parametrize("script,args,expect", [
    ("optimal_sampling.py", [], "optimized 256 clients"),
    ("quickstart.py", ["--device", "cpu"], "fedbuff    final accuracy"),
])
def test_runs_on_the_cpu(script, args, expect):
    res = subprocess.run([sys.executable, str(EXAMPLES / script), *args], capture_output=True,
                         text=True, timeout=600, env=ENV, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert expect in res.stdout
