"""Build and load the port's CUDA kernels.

Every ``cldrd_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` into its own
shared library with a plain C entry point, under ``build/kernels/`` at the
root of the checkout, at first use. One ``nvcc`` process per source, all
started together. A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source rebuilds and a stale
library is never loaded. Libraries load with ``ctypes``; each wrapper
passes pointers and the stream as ``c_void_p`` and raises on the
``cudaError_t`` the entry point returns.

Sources come only from this package. A failed build raises; nothing falls
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # per source, from the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of cldrd_tpu_torch build from "
        "csrc/*.cu with the CUDA toolkit (put nvcc on PATH)")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns
    ``{stem: library path}``. Raises with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for src in sources():
        out = _library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(src)]
        jobs.append((src, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, t0, proc in jobs:
        log, _ = proc.communicate()
        BUILD_SECONDS[src.stem] = time.perf_counter() - t0
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode:
            errors.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {src.stem: _library_path(src) for src in sources()}


def build_log(stem: str) -> str:
    """nvcc's output (with ``-Xptxas -v`` register/spill report) from the
    build of ``csrc/<stem>.cu`` in this checkout, if it was built here."""
    path = BUILD_DIR / f"{stem}.log"
    return path.read_text() if path.exists() else ""


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no kernel source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _LIBS[stem] = lib
        return lib


def dtype_code(dtype) -> int:
    """dtype code of the C entry points (csrc/score_tile.cuh: DType)."""
    import torch

    return {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype]


def check_search_operands(kernel: str, queries, corpus, row_ids, scales):
    """What both search kernels require of their operands, checked before
    any pointer reaches them: one CUDA device, contiguous and 16-byte
    aligned tensors, matching dims with D % 16 == 0, bf16/fp32 queries,
    bf16/fp32/int8 rows, int32 ids and fp32 scales, one per row."""
    import torch

    dev = queries.device
    named = [("queries", queries), ("corpus", corpus), ("row_ids", row_ids)]
    if scales is not None:
        named.append(("scales", scales))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, queries on "
                             f"{dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             "16-byte aligned")
    d, d2 = queries.shape[1], corpus.shape[1]
    n = corpus.shape[0]
    if d != d2 or d % 16:
        raise ValueError(f"{kernel}: dims {d} vs {d2} (must match and be a "
                         "multiple of 16)")
    if queries.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: query dtype {queries.dtype}")
    if corpus.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise TypeError(f"{kernel}: corpus dtype {corpus.dtype}")
    if row_ids.dtype != torch.int32 or row_ids.shape != (n,):
        raise ValueError(f"{kernel}: row_ids must be int32 [N]")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (n,)):
        raise ValueError(f"{kernel}: scales must be float32 [N]")


def launch(stem: str, fn_name: str, argtypes, *args, device) -> None:
    """Call the C entry point ``fn_name`` of ``csrc/<stem>.cu`` on
    ``device``'s current stream (passed last); raise on a non-zero
    ``cudaError_t``."""
    import torch

    fn = getattr(load(stem), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{stem}: kernel launch failed with CUDA error "
                           f"{status}")
