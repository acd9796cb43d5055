"""Nothing under ``bench/`` imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(the part before the first dot) is compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NO_JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports (relative
    imports resolve inside the benchmark)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert NO_JAX.isdisjoint(imported(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert "repro_torch" not in names and NO_JAX.isdisjoint(names)
    assert names <= {"__future__", "dataclasses", "typing", "numpy"}


def test_the_names_are_compared_whole():
    assert "repro_torch".split(".", 1)[0] not in NO_JAX


def test_a_run_loads_no_jax():
    """The modules a run loads (the harness, the program's miner, the
    reference and every metric reader) leave no JAX module behind."""
    code = (
        "import sys; sys.argv = ['x']; "
        f"sys.path[:0] = [{str(BENCH.parent)!r}, "
        f"{str(BENCH.parent / 'src')!r}]; "
        "from bench import run; import repro_torch.core.eclat; "
        "from bench import devtrace, control; "
        "[run.reader(p.stem) for p in (run.BENCH / 'metrics').glob('*.py')]; "
        "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
