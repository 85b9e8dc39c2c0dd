"""No module of perfbench imports JAX, its libraries or the JAX package;
the references import nothing of the port either. Top-level names are
compared whole: vimoclip_tpu_torch begins with vimoclip_tpu but is not
it."""

import ast

import pytest

from perfbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vimoclip_tpu"}
SOURCES = sorted(registry.HERE.rglob("*.py"))


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(registry.HERE)))
def test_no_forbidden_import(path):
    names = imported(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(registry.HERE).parts:
        assert "vimoclip_tpu_torch" not in names


def test_the_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vimoclip_tpu_torch.serving\nfrom vimoclip_tpu import x\n")
    assert imported(f) == {"vimoclip_tpu_torch", "vimoclip_tpu"}
