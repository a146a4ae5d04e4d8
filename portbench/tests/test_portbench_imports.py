"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "comet_tpu"}


def _top_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_of_a_cell_loads_no_jax():
    code = (
        "import sys, json, time, torch\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from portbench_tiny import tiny_cell\n"
        "from portbench import run\n"
        "r = run.run_cell(tiny_cell(), 1, 0.5, False, torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _top_modules(code)
    assert "comet_tpu_torch" in mods  # the program ran
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import portbench.reference.comet, portbench.reference.flops, "
            "portbench.reference.precision\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _top_modules(code)
    assert not mods & (FORBIDDEN | {"comet_tpu_torch"}), mods


def test_no_source_of_the_reference_or_the_harness_names_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.parts:
            assert "comet_tpu_torch" not in names, path
