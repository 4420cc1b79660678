"""The port stands alone: no file of it, of its CLIs and bench, of its
script twins or of its chip smoke run imports JAX, flax, optax or the
reference package.

An AST scan of each file (one case per file) fails on any ``import`` or
``from ... import`` of ``jax``, ``flax``, ``optax`` or
``opencv_traffic_sign_detector_tpu`` or of one of their submodules, at any
depth of the file.  Relative imports
inside the port resolve to the port.  ``tests/test_torch_ops.py:
test_port_imports_no_jax`` checks the same at run time through
``sys.modules``.
"""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "opencv_traffic_sign_detector_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "opencv_traffic_sign_detector_tpu")


def _port_files() -> list[str]:
    """The root ``*_torch.py`` entry points, ``scripts/*_torch.py``,
    ``chip_smoke.py`` and every module of the port."""
    files = sorted(os.path.relpath(p, REPO) for pattern in ("*_torch.py", "scripts/*_torch.py")
                   for p in glob.glob(os.path.join(REPO, pattern)))
    files.append("chip_smoke.py")
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += sorted(os.path.relpath(os.path.join(root, n), REPO)
                        for n in names if n.endswith(".py"))
    return files


def forbidden_imports(source: str) -> list[str]:
    """Absolute imports of a forbidden package or its submodules."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names
                  if any(n == f or n.startswith(f + ".") for f in FORBIDDEN)]
    return found


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_neither_jax_nor_the_reference(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        assert forbidden_imports(f.read()) == [], path


@pytest.mark.parametrize("source, found", [
    ("import opencv_traffic_sign_detector_tpu", ["opencv_traffic_sign_detector_tpu"]),
    ("from opencv_traffic_sign_detector_tpu.data import gt",
     ["opencv_traffic_sign_detector_tpu.data"]),
    ("def f():\n    import jax.numpy as jnp", ["jax.numpy"]),
    ("import opencv_traffic_sign_detector_tpu_torch.ops", []),
    ("from .config import MSERConfig", []),
    ("import jaxlib_like", []),
    ("import flax.linen as nn", ["flax.linen"]),
    ("from optax import adamw", ["optax"]),
])
def test_scan_finds_forbidden_imports(source, found):
    assert forbidden_imports(source) == found
