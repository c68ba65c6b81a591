"""The benchmark loads neither JAX nor the JAX package, and its reference
nothing of the program. Each check runs in a fresh interpreter, because the
test process itself may hold JAX."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
BANNED = ("jax", "jaxlib", "flax", "convolutional_diffusion_tpu")
PORT = "convolutional_diffusion_tpu_torch"


def _modules(where: Path):
    for path in sorted(where.rglob("*.py")):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _loaded_after(imports, extra: str = "") -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in imports) + extra
            + "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_and_the_port_leave_jax_out():
    """Every benchmark module, and the program modules a run drives (the
    window's whole path, on the CPU), load no banned top-level name."""
    drive = ("from port_bench import run, spec\n"
             "from pathlib import Path\n"
             f"cell = spec.load('els-cifar10-highest.cond-b8', Path({str(ROOT)!r}))\n"
             "cell = cell._replace(config=dict(cell.config, num_images=24, image_size=8,"
             " scales=[3, 3, 5], target_block=1024, scorebatchsize=8))\n"
             "cell = cell._replace(traffic=dict(cell.traffic, check_samples=1))\n"
             "run.run_cell(cell, 5, 0.0, False, 'cpu', 0.0)\n")
    loaded = _loaded_after(list(_modules(BENCH)), drive)
    assert PORT in loaded  # the drive did reach the program
    assert not loaded & set(BANNED), sorted(loaded & set(BANNED))


@pytest.mark.parametrize("module", list(_modules(BENCH / "reference")))
def test_reference_imports_nothing_of_the_program(module):
    loaded = _loaded_after([module])
    assert not loaded & {PORT, *BANNED}, sorted(loaded & {PORT, *BANNED})


def test_reference_sources_name_no_program():
    """The reference's sources import only the standard library, numpy,
    torch and the reference itself."""
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in {PORT, *BANNED}, (path.name, name)
