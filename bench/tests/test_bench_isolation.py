"""Nothing under bench/ imports JAX or the JAX package (`repro`, compared
as a whole top-level name, so that `repro_torch` is another name), and
nothing under bench/reference/ or bench/port/ imports the program."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", sorted((BENCH / "port").glob("*.py")),
                         ids=lambda p: f"port/{p.name}")
def test_a_port_module_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"bench"}
