"""Static hygiene: no unused imports or syntax errors in tpu_se/.

pyflakes is not installed in this image; this is the subset of it that
keeps the hygiene bar permanent: every module must parse,
and every top-level import must be referenced somewhere in the module
(re-export modules are exempted via __all__)."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "tpu_se"
MODULES = sorted(PKG.rglob("*.py"))


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.asname or a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    yield a.asname or a.name, node.lineno


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_unused_imports(path):
    src = path.read_text()
    tree = ast.parse(src, filename=str(path))

    exported = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            exported = {e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)}

    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            base = node
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name):
                used.add(base.id)

    unused = [(name, line) for name, line in _imported_names(tree)
              if name not in used and name not in exported]
    assert not unused, f"{path}: unused imports {unused}"
