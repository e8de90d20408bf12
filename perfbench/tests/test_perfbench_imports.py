"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under perfbench/, nothing of the old harnesses, and in the
reference nothing of the program either.  Top-level module names are
compared whole: ``apex_tpu_torch`` begins with ``apex_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "apex_tpu", "chip_smoke", "bench",
         "bench_kernels"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_old_harnesses(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "apex_tpu_torch" not in set(_imports(path))
    assert "perfbench" not in set(_imports(path))   # only its own modules


def _loaded_after(code: str) -> set:
    """Top-level modules a fresh interpreter holds after ``code``, with the
    environment's own start-up hooks left out (-I)."""
    out = subprocess.run(
        [sys.executable, "-I", "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    mods = _loaded_after(
        "import perfbench.reference.transformer, perfbench.reference.resnet,"
        " perfbench.reference.optim, perfbench.reference.lowp, "
        "perfbench.reference.hash")
    assert not mods & (NEVER | {"apex_tpu_torch"})
