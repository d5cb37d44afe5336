"""The port stands alone: no module of cldrd_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax or anything of cldrd_tpu."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cldrd_tpu_torch")

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "cldrd_tpu")
_SCRIPT = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises
sys.path.insert(0, {ROOT!r})
import importlib, pkgutil
import cldrd_tpu_torch
names = ["cldrd_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(cldrd_tpu_torch.__path__,
                                          "cldrd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in {_BLOCKED!r} and sys.modules[n])
assert not leaked, leaked
print(len(names))
"""


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_without_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


def test_sources_import_nothing_of_jax_or_the_reference():
    imports = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)
    banned = re.compile(r"^(?:jax|jaxlib|flax|optax)\b|^cldrd_tpu\b(?!_torch)")
    found = []
    for path in _sources():
        text = open(path, encoding="utf-8").read()
        for mod in imports.findall(text):
            if banned.search(mod):
                found.append(f"{os.path.relpath(path, ROOT)}: {mod}")
        if re.search(r"importlib\.import_module\(\s*['\"](?:jax|flax|optax|"
                     r"cldrd_tpu['\".])", text):
            found.append(f"{os.path.relpath(path, ROOT)}: dynamic import")
    assert not found, found


def test_the_walk_reaches_the_parallel_package():
    """The import check walks every subpackage; the multi-device one
    (parallel/) is among them."""
    import pkgutil

    import cldrd_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(cldrd_tpu_torch.__path__,
                                                   "cldrd_tpu_torch.")}
    assert {"cldrd_tpu_torch.parallel", "cldrd_tpu_torch.parallel.mesh",
            "cldrd_tpu_torch.parallel.multihost"} <= names
