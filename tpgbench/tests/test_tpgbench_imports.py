"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port: top-level module names
compared whole."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "fdreadoutlibs_tpu"}


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                names.add("." * node.level + (node.module or ""))
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not imported_top_names(path) & BANNED


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = imported_top_names(path)
    relative = {n for n in names if n.startswith(".")}
    absolute = names - relative
    assert absolute <= {"__future__", "numpy", "pathlib"}
    # relative imports stay inside the reference package
    assert all(n.startswith(".") and not n.startswith("..")
               for n in relative)


def test_prefix_not_taken_for_the_jax_package():
    from tpgbench.harness import banned_modules
    import sys
    sys.modules.setdefault("fdreadoutlibs_tpu_torch_probe_only", None)
    try:
        assert "fdreadoutlibs_tpu" not in banned_modules()
    finally:
        sys.modules.pop("fdreadoutlibs_tpu_torch_probe_only", None)
