"""The host runtime's native (C++) parsers (port of ``cldrd_tpu/native``).

Two CPython extensions, the port's own copies of the reference's
sources, compiled with ``g++`` at first use (not at import) into
``build/native/`` at the root of the checkout:

- ``_tsvparse``: mmap TSV corpus parser (``parse_id_text_tsv``,
  ``count_lines``), used by ``cldrd_tpu_torch.data.loaders``;
- ``_jsonlparse``: mmap flat-JSONL training-file parser (``parse_jsonl``);
  it raises ``ValueError`` on any construct outside the training schema
  and the loader then parses that file with ``json.loads``.

A library's file name carries a hash of its source, the flags and the
interpreter's extension suffix, so an edited source rebuilds and a stale
library is never loaded. ``CLDRD_TPU_TORCH_NO_NATIVE=1`` turns the
parsers off; the loaders then take their pure-Python path and log that
they do.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict

NO_NATIVE_ENV = "CLDRD_TPU_TORCH_NO_NATIVE"
SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
SOURCES = {"_tsvparse": "tsvparse.cpp", "_jsonlparse": "jsonlparse.cpp"}

_LOCK = threading.Lock()
_MODULES: Dict[str, ModuleType] = {}


def _library_path(name: str) -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(" ".join(CXX_FLAGS + [suffix]).encode())
    h.update((SRC_DIR / SOURCES[name]).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    """Compile one extension; raises ``ImportError`` with g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS,
           f"-I{sysconfig.get_paths()['include']}",
           str(SRC_DIR / SOURCES[name]), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise ImportError(f"native build of {name}: {e}") from e
    except subprocess.CalledProcessError as e:
        raise ImportError(f"native build of {name} failed:\n{e.stderr}") \
            from e
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole file


def load(name: str) -> ModuleType:
    """The extension ``name`` ('_tsvparse' or '_jsonlparse'), built if
    missing. Raises ``ImportError`` when the parsers are turned off or the
    build fails."""
    if os.environ.get(NO_NATIVE_ENV):
        raise ImportError(f"native parsers turned off ({NO_NATIVE_ENV})")
    with _LOCK:
        mod = _MODULES.get(name)
        if mod is None:
            path = _library_path(name)
            if not path.exists():
                _build(name, path)
            # the module's name selects PyInit_<last part>; the file's
            # name does not matter
            full = f"{__name__}.{name}"
            loader = importlib.machinery.ExtensionFileLoader(full, str(path))
            spec = importlib.util.spec_from_file_location(full, path,
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _MODULES[name] = mod
        return mod


def parse_id_text_tsv(path: str, allow_title: bool = False):
    """``id\\ttext`` (and, with ``allow_title``, ``id\\ttitle\\tpara``)
    rows -> {id: text | {"title", "para"}}."""
    return load("_tsvparse").parse_id_text_tsv(path, allow_title=allow_title)


def count_lines(path: str) -> int:
    return load("_tsvparse").count_lines(path)


def parse_jsonl(path: str) -> list:
    """Flat training-schema JSONL -> list of dicts; ``ValueError`` on any
    construct outside that schema."""
    return load("_jsonlparse").parse_jsonl(path)


__all__ = ["NO_NATIVE_ENV", "count_lines", "load",
           "parse_id_text_tsv", "parse_jsonl"]
