"""No module of the benchmark imports JAX, its libraries or the JAX
package, and the reference imports nothing of the port either. Names are
compared whole, by their top-level part: the port's name begins with the
JAX package's."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cldrd_tpu"}


def _modules():
    for dirpath, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(_modules())


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, HERE) for p in MODULES])
def test_no_jax_import(path):
    bad = FORBIDDEN & set(_imports(path))
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", [p for p in MODULES if os.sep + "reference"
                                  + os.sep in p])
def test_reference_imports_nothing_of_the_port(path):
    bad = (FORBIDDEN | {"cldrd_tpu_torch", "portbench"}) & set(_imports(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_walk_reaches_every_part():
    rel = {os.path.relpath(p, HERE) for p in MODULES}
    for part in ("run.py", "harness.py", "roofline.py",
                 os.path.join("reference", "encoder.py"),
                 os.path.join("drivers", "train.py"),
                 os.path.join("metrics", "k1_roofline.py")):
        assert part in rel


def test_names_compared_whole():
    """``cldrd_tpu_torch`` is not ``cldrd_tpu``."""
    assert "cldrd_tpu_torch".split(".")[0] not in FORBIDDEN
