"""What the benchmark's modules import: nothing of JAX or the JAX package
anywhere (top-level module names compared whole: parakeet_tpu_torch, the
port, begins with the JAX package's name and is allowed), and nothing of
the program in the reference."""

import ast
import subprocess
import sys

import pytest

from port_bench.tests.tiny import REPO

BANNED = {"jax", "jaxlib", "flax", "parakeet_tpu"}
FILES = sorted((REPO / "port_bench").rglob("*.py"))
REFERENCE_ALLOWED = {"__future__", "math", "dataclasses", "numpy", "torch"}


def imported(path) -> set[str]:
    """Top-level names of every absolute import, and of every
    importlib.import_module("...") with a literal name, in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_anywhere(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((REPO / "port_bench/reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= REFERENCE_ALLOWED, imported(path) - REFERENCE_ALLOWED


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of the tiny cell on the CPU, in a fresh interpreter."""
    code = ("import sys, time; s = time.perf_counter(); sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from port_bench import harness\n"
            "from port_bench.tests.tiny import tiny_root\n"
            "root = tiny_root(Path(%r))\n"
            "harness.run(root, 'tiny.cell', 5, 0.2, False, s, device='cpu')\n"
            "print('LOADED', harness.banned_modules())\n") % (str(REPO), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
