"""Device groups and row-sharded tensors (port of
``cldrd_tpu/parallel/mesh.py``).

The reference runs every multi-device path as one SPMD program over a 1-D
``jax.sharding.Mesh``. The port keeps its split:

- search, index builds and serving use the devices of ONE process: a
  ``Mesh`` here is an ordered list of ``torch.device``s with an axis name,
  and a corpus-sharded store is a ``Sharded`` tensor whose part j lives on
  ``mesh.devices[j]`` (FAISS's ``IndexShards``);
- training uses ``torch.distributed``, one process per device
  (``parallel/multihost.py``, ``train/trainer.py``).

A mesh may repeat a device: ``Mesh((cuda:0, cuda:0))`` runs the sharded
code paths on a one-GPU machine. ``make_mesh`` never repeats a GPU; on the
CPU it gives ``n`` CPU entries, the stand-in for the reference's virtual
CPU devices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
CORPUS_AXIS = "corpus"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered group of devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device: DeviceLike = None) -> Mesh:
    """A mesh over the first ``n_devices`` local devices of ``device``'s
    type (``None`` is CUDA). ``None`` or 0 means all of them: every visible
    GPU, or the one CPU. Asking for more GPUs than are visible raises, as
    the reference asserts; on the CPU ``n`` gives ``n`` entries."""
    dev = resolve_device(device)
    n = n_devices or None
    if n is not None and n < 0:
        raise ValueError(f"device count must be >= 0 (got {n_devices})")
    if dev.type == "cpu":
        return Mesh((torch.device("cpu"),) * (n or 1), axis_name)
    have = torch.cuda.device_count()
    if n is not None and n > have:
        raise ValueError(f"asked for {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n or have)),
                axis_name)


class Sharded:
    """A tensor row-sharded over a mesh: ``parts[j]``, on
    ``mesh.devices[j]``, holds global rows ``[j*r, (j+1)*r)`` with r the
    rows of a part (all parts have the same shape)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts: List[torch.Tensor] = list(parts)
        shapes = {tuple(p.shape) for p in self.parts}
        if len(shapes) != 1:
            raise ValueError(f"parts of unequal shapes {sorted(shapes)}")

    @property
    def part_rows(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> torch.Size:
        first = self.parts[0].shape
        return torch.Size((first[0] * len(self.parts), *first[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def float(self) -> "Sharded":
        return Sharded([p.float() for p in self.parts])

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host, in global row order."""
        return torch.cat([p.cpu() for p in self.parts])

    def take(self, rows: np.ndarray) -> torch.Tensor:
        """Global rows ``rows`` (host int array), gathered from their
        parts onto the first part's device."""
        rows = np.asarray(rows, np.int64)
        out = torch.empty((len(rows), *self.shape[1:]), dtype=self.dtype,
                          device=self.device)
        part, local = np.divmod(rows, self.part_rows)
        for j in np.unique(part):
            sel = np.flatnonzero(part == j)
            src = self.parts[j]
            out[torch.from_numpy(sel).to(self.device)] = src[
                torch.from_numpy(local[sel]).to(src.device)].to(self.device)
        return out


def shard_rows(x, mesh: Mesh, dtype: Optional[torch.dtype] = None
               ) -> Sharded:
    """Split ``x`` (host array or tensor) into ``mesh.size`` equal row
    blocks, block j onto ``mesh.devices[j]`` (cast to ``dtype`` there)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.size} devices")
    return Sharded([blk.to(dev, dtype or blk.dtype)
                    for blk, dev in zip(t.chunk(mesh.size), mesh.devices)])

