"""No module of the benchmark imports JAX, its libraries or the JAX package:
each import's top-level name (before the first dot) is compared whole, so
the port, gs2m_tpu_torch, passes."""
import ast
from pathlib import Path

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "gs2m_tpu"}


def imported_top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(Path(BENCH).rglob("*.py"))
    assert len(files) > 10
    bad = {str(f): imported_top_levels(f) & FORBIDDEN for f in files}
    assert not {f: n for f, n in bad.items() if n}


def test_the_port_passes_the_comparison():
    assert "gs2m_tpu_torch".split(".")[0] not in FORBIDDEN
    from cellkit.runner import forbidden_modules

    assert forbidden_modules() == []
