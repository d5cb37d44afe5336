"""The benchmark's inputs, made from ``--seed``: texts, weights and store
rows. The port and the reference are handed the same.

- Sub-seeds: ``numpy.random.SeedSequence([seed, tag])`` per purpose, so
  one seed of any size gives independent streams.
- Lengths are a fixed set for every seed: the distribution's quantiles
  (log-normal words a text, clipped), put in an order drawn from the
  seed. So every seed does the same work, and the seed changes which
  words and which order.
- Words: a vocabulary of pseudo-words drawn by a Zipf law of rank.
- Weights: one ``torch.randn`` on the device for all parameters (std
  ``initializer_range``; LayerNorm weights 1 plus that noise), as views.
- Store rows: clusters (centres, noise, a log-normal norm per row), made
  on the device a block at a time, each block from its own generator, so
  the reference can make any block again.
"""
from __future__ import annotations

import os
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_TAGS = {"text": 1, "weights": 2, "store": 3, "centres": 4, "order": 5,
         "examples": 7, "train": 8}


def sub_seed(seed: int, tag: str, *more: int) -> int:
    """A 63-bit seed for ``tag`` (and ``more``) from the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             _TAGS[tag], *more]
    w = np.random.SeedSequence(words).generate_state(2)
    return (int(w[0]) << 31) ^ int(w[1])


def rng(seed: int, tag: str, *more: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag, *more))


def length_set(n: int, spec: dict) -> np.ndarray:
    """``n`` word counts: the log-normal's quantiles at (i + 0.5) / n with
    mean ``spec['mean']`` and log-sd ``spec['sigma']``, rounded and
    clipped to [min, max]. The same set for every seed."""
    sigma = spec["sigma"]
    mu = np.log(spec["mean"]) - sigma * sigma / 2
    z = np.asarray([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                    for i in range(n)])
    return np.clip(np.rint(np.exp(mu + sigma * z)), spec["min"],
                   spec["max"]).astype(np.int64)


def _vocab(size: int) -> np.ndarray:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    idx = np.arange(size)
    parts = []
    for _ in range(4):
        parts.append(letters[idx % 26])
        idx = idx // 26
    return np.char.add(np.char.add(np.char.add(parts[3], parts[2]),
                                   parts[1]), parts[0])


def texts(seed: int, tag: int, n: int, spec: dict, vocab_size: int,
          zipf: float) -> List[str]:
    """``n`` texts of ``length_set`` word counts in a seeded order."""
    g = rng(seed, "text", tag)
    lengths = length_set(n, spec)[g.permutation(n)]
    p = 1.0 / np.arange(1, vocab_size + 1) ** zipf
    cdf = np.cumsum(p / p.sum())
    words = _vocab(vocab_size)[np.minimum(
        np.searchsorted(cdf, g.random(int(lengths.sum()))),
        vocab_size - 1)].tolist()
    out, pos = [], 0
    for length in lengths:
        out.append(" ".join(words[pos:pos + length]))
        pos += length
    return out


def write_tsv(path: str, ids: Sequence[int], rows: Sequence[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for i, text in zip(ids, rows):
            f.write(f"{i}\t{text}\n")


def work_dir() -> str:
    """A fresh directory for this run's data under ``TMPDIR``."""
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))


# ------------------------------------------------------------- weights


def make_weights(specs: Sequence[Tuple[str, tuple, str]], seed: int,
                 device, std: float) -> Dict[str, torch.Tensor]:
    """Every parameter of ``specs`` from one ``randn`` on ``device``."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(std)
    out, pos = {}, 0
    for (name, shape, kind), size in zip(specs, sizes):
        t = flat[pos:pos + size].view(shape)
        if kind == "ln_w":
            t.add_(1.0)
        out[name] = t
        pos += size
    return out


# --------------------------------------------------------- store rows


def store_centres(seed: int, n_centres: int, dim: int, device
                  ) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "centres"))
    return torch.randn(n_centres, dim, generator=gen, device=device)


def store_block(seed: int, block: int, rows: int, centres: torch.Tensor,
                spec: dict) -> torch.Tensor:
    """Rows of store block ``block`` (float32 [rows, D]): a uniformly drawn
    centre each, plus ``noise`` times Gaussian noise, times
    ``exp(norm_sigma * z)``. Rows of a cluster lie anywhere in the store,
    as passages of a topic do in a collection's order."""
    dev = centres.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(sub_seed(seed, "store", block))
    assign = torch.randint(0, centres.shape[0], (rows,), generator=gen,
                           device=dev)
    out = torch.randn(rows, centres.shape[1], generator=gen, device=dev)
    out.mul_(spec["noise"]).add_(centres[assign])
    norms = torch.randn(rows, generator=gen, device=dev)
    return out.mul_(torch.exp(norms * spec["norm_sigma"])[:, None])
