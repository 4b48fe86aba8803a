"""Nothing under ``bench/`` imports JAX, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port),
and the yardstick and the references import nothing of the port."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what both sides of the comparison share, and the references: none of it
# may lean on the program it judges
PORT_FREE = (sorted((BENCH / "reference").glob("*.py"))
             + [BENCH / "harness" / n for n in (
                 "inputs.py", "trainref.py", "yardstick.py", "tracing.py",
                 "spec.py", "__init__.py")]
             + sorted((BENCH / "metrics").glob("*.py")))


def imports(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def top(mod: str) -> str:
    return mod.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_and_no_jax_package(path):
    bad = [m for m in imports(path) if top(m) in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", PORT_FREE,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_the_yardstick_imports_nothing_of_the_port(path):
    bad = [m for m in imports(path) if top(m) == "repro_torch"]
    assert not bad, bad


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jax import numpy\n"
                 "import reprox\nfrom repro.core import zen\nimport flax\n")
    assert [m for m in imports(f) if top(m) in FORBIDDEN] == [
        "jax", "repro.core", "flax"]


def test_the_reference_runs_without_the_port_loaded():
    """A fresh interpreter loads the reference and the yardstick, and then
    no module of the port (or of JAX) is there."""
    import subprocess
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from harness import inputs, trainref, yardstick, spec\n"
        "spec.load_module(spec.BENCH / 'reference' / 'dense_gqa.py', 'r')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]\n"
        "print(bad)\n") % str(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
