"""What the benchmark's modules import, read from their sources: none
imports JAX or the JAX package (each import's top-level name compared
whole: the port's name begins with the JAX package's), and the plain
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FOREIGN = {"jax", "jaxlib", "flax", "msmp_pde_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    """The top-level names (before the first dot) of every module that
    the file imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import msmp_pde_torch.ops\nfrom jax.numpy import x\n"
                 "import jaxtyping\n")
    assert top_level_imports(f) == {"msmp_pde_torch", "jax", "jaxtyping"}
    assert top_level_imports(f) & FOREIGN == {"jax"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & FOREIGN


REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "math", "torch", "benchmark"}
    assert top_level_imports(path) <= allowed
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference")


def test_the_harness_reads_no_old_bench_file():
    old = ("bench.py", "BENCH_r0", "MULTICHIP_r0", "bench_cache",
           "chip_smoke", "msmp_pde_torch.tools")
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        code = [n for n in ast.walk(ast.parse(text))
                if isinstance(n, (ast.Import, ast.ImportFrom, ast.Constant))]
        for n in code:
            s = (n.value if isinstance(n, ast.Constant) else
                 ast.unparse(n))
            if isinstance(s, str):
                assert not any(o in s for o in old[:4]), (path, s)
                if not isinstance(n, ast.Constant):
                    assert not any(o in s for o in old[4:]), (path, s)
