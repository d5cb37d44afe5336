"""Index persistence: blocked binary shards + ``ids.npy`` + JSON meta
(copy of ``cldrd_tpu/index/persistence.py``: both packages read and write
the same store).

fp32 is the default store dtype; ``int8`` writes per-row-scaled codes plus
``scales.npy``, which load straight into an int8 device index with no
dequantize/requantize round trip.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

META_NAME = "meta.json"
IDS_NAME = "ids.npy"
SCALES_NAME = "scales.npy"


def write_embeddings(out_dir: str, embeddings: np.ndarray, ids: np.ndarray,
                     rows_per_shard: int = 500_000,
                     dtype: str = "float32") -> None:
    """Write [N, D] embeddings as blocked binary shards + ids + meta."""
    os.makedirs(out_dir, exist_ok=True)
    n, d = embeddings.shape
    assert ids.shape == (n,)
    if dtype == "int8":
        from .flat_index import quantize_rows

        embeddings, scales = quantize_rows(embeddings)
        np.save(os.path.join(out_dir, SCALES_NAME), scales)
    _write_store(out_dir, embeddings, ids, rows_per_shard, dtype)


def _write_store(out_dir, rows, ids, rows_per_shard, dtype_str) -> None:
    n, d = rows.shape
    assert ids.shape == (n,), (ids.shape, n)
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for shard_idx, start in enumerate(range(0, n, rows_per_shard)):
        end = min(start + rows_per_shard, n)
        name = f"embs_{shard_idx:05d}.bin"
        block = np.ascontiguousarray(rows[start:end], dtype=np.dtype(dtype_str))
        block.tofile(os.path.join(out_dir, name))
        shards.append({"file": name, "rows": end - start})
    np.save(os.path.join(out_dir, IDS_NAME), ids.astype(np.int64))
    meta = {
        "n_vectors": int(n),
        "dim": int(d),
        "dtype": dtype_str,
        "rows_per_shard": int(rows_per_shard),
        "shards": shards,
        "format_version": 1,
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)


def write_quantized(out_dir: str, codes: np.ndarray, scales: np.ndarray,
                    ids: np.ndarray, rows_per_shard: int = 500_000) -> None:
    """Write an int8 store from pre-quantized codes + scales (no
    dequantize/requantize round trip, e.g. a live int8 index)."""
    assert codes.dtype == np.int8 and scales.shape == (codes.shape[0],)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, SCALES_NAME), scales.astype(np.float32))
    _write_store(out_dir, codes, ids, rows_per_shard, "int8")


def _read_raw(out_dir: str, mmap: bool, out_dtype) -> Tuple[np.ndarray,
                                                            np.ndarray, dict]:
    with open(os.path.join(out_dir, META_NAME)) as f:
        meta = json.load(f)
    n, d = meta["n_vectors"], meta["dim"]
    dt = np.dtype(meta["dtype"])
    out = np.empty((n, d), out_dtype)
    row = 0
    for shard in meta["shards"]:
        path = os.path.join(out_dir, shard["file"])
        rows = shard["rows"]
        block = (np.memmap(path, dtype=dt, mode="r", shape=(rows, d)) if mmap
                 else np.fromfile(path, dtype=dt).reshape(rows, d))
        out[row: row + rows] = block
        row += rows
    assert row == n
    ids = np.load(os.path.join(out_dir, IDS_NAME))
    return out, ids, meta


def read_embeddings(out_dir: str, mmap: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Read back (embeddings fp32 [N, D], ids int64 [N]); an int8 store
    dequantizes (codes x per-row scale)."""
    with open(os.path.join(out_dir, META_NAME)) as f:
        meta = json.load(f)
    if meta["dtype"] == "int8":
        codes, ids, _ = _read_raw(out_dir, mmap, np.int8)
        scales = np.load(os.path.join(out_dir, SCALES_NAME))
        return codes.astype(np.float32) * scales[:, None], ids
    out, ids, _ = _read_raw(out_dir, mmap, np.float32)
    return out, ids


def index_exists(out_dir: str) -> bool:
    return os.path.isfile(os.path.join(out_dir, META_NAME))


def load_index(out_dir: str, dtype=None, block_rows: int = 8192,
               precision: str = "default", device=None, mesh=None):
    """Read an embedding store and stand up a device ``FlatIPIndex``
    (``dtype``: torch dtype of the device store, bf16 by default). An int8
    store loaded with ``dtype=torch.int8`` goes codes -> device directly.
    ``mesh`` loads it straight into row shards over the mesh's devices."""
    import torch

    from .flat_index import FlatIPIndex

    dtype = dtype or torch.bfloat16
    with open(os.path.join(out_dir, META_NAME)) as f:
        disk_dtype = json.load(f)["dtype"]
    if disk_dtype == "int8" and dtype == torch.int8:
        codes, ids, _ = _read_raw(out_dir, True, np.int8)
        scales = np.load(os.path.join(out_dir, SCALES_NAME))
        return FlatIPIndex.build_quantized(
            codes, scales, ids, block_rows=block_rows, precision=precision,
            device=device, mesh=mesh)
    embs, ids = read_embeddings(out_dir)
    return FlatIPIndex.build(embs, ids, dtype=dtype, block_rows=block_rows,
                             precision=precision, device=device, mesh=mesh)
