"""What the benchmark runs imports neither JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pocket_tts_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        # the reference stands alone: no module of the port, none of the harness
        assert "pocket_tts_tpu_torch" not in tops
        assert all(n.startswith("ttsbench.reference") for n in _imports(path)
                   if n.split(".")[0] == "ttsbench")


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, importlib, pathlib\n"
        "sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        "for p in sorted(pathlib.Path('ttsbench').rglob('*.py')):\n"
        "    if 'tests' not in p.parts:\n"
        "        name = '.'.join(p.with_suffix('').parts).removesuffix('.__init__')\n"
        "        importlib.import_module(name)\n"
        "from ttsbench import harness\n"
        "from ttsbench.tests.tiny import tiny_spec\n"
        "r, _ = harness.run_cell('english-clone-b1', 4, 1.0, False, 'cpu', "
        "spec=tiny_spec('english-clone-b1'))\n"
        "assert r['correct'], r\n"
        "found = {n.split('.')[0] for n in sys.modules} & "
        + repr(FORBIDDEN) + "\n"
        "assert not found, found\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
