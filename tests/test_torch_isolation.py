"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports jax or the JAX package ``repro``, directly or
through ``importlib`` / ``__import__``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _const_str(node) -> str:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else ""


def _violations(source: str, filename: str = "<source>"):
    tree = ast.parse(source, filename=filename)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            # Relative imports (level > 0) stay inside the port.
            if node.level == 0 and node.module and _forbidden(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = (
                fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in ("import_module", "__import__"):
                target = _const_str(node.args[0])
                if not target or _forbidden(target):
                    found.append(f"{name}({target or '<dynamic>'})")
    return found


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_exist():
    files = _port_files()
    assert (PORT / "__init__.py") in files
    assert all(f.exists() for f in files), [f for f in files if not f.exists()]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert _violations(path.read_text(), str(path)) == []


def test_scanner_catches_each_form():
    src = (
        "import jax\n"
        "from jax import numpy\n"
        "import repro.core\n"
        "from repro.sim import x\n"
        "import importlib\n"
        "importlib.import_module('repro.kernels')\n"
        "__import__('jax.numpy')\n"
        "importlib.import_module(name)\n"
        "from . import sibling\n"
        "import repro_torch.core\n"
    )
    assert sorted(_violations(src)) == sorted([
        "jax", "jax", "repro.core", "repro.sim",
        "import_module(repro.kernels)", "__import__(jax.numpy)",
        "import_module(<dynamic>)",
    ])
