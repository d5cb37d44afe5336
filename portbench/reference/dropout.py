"""Dropout masks of a training step, worked out again from the seed.

The port draws the masks of step ``n`` (counted from 0) of a run seeded
``seed`` as follows, and the reference draws the same:

- ``numpy.random.SeedSequence([seed mod 2^32, n mod 2^32])`` gives three
  32-bit words ``w0, w1, w2``;
- hidden-state and last-block attention-probs masks: ``torch.rand`` of
  the tensor's shape from a ``torch.Generator`` on the step's device
  seeded ``w0 << 32 | w1``, keep where the draw is ``>= p``, in the order
  of the forward (query tower, then passage tower; embeddings, then each
  block's attention, attention output and FFN output);
- attention-probs masks inside the fused attention (every block but the
  last): one int32 seed a block from ``numpy.random.default_rng(w2)``
  (``integers(-2^31, 2^31)``), and a counter hash of the element index
  ``((b*H + h)*Lq + q)*Lk + k`` xor the seed: the murmur3-style
  finalizer with the constants 0xC2B2AE3D and 0x85EBCA6B, in 32-bit
  unsigned arithmetic, whose top 24 bits over 2^24 are kept when ``>= p``.

Kept values are scaled by ``1 / (1 - p)``.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1 = -1028477379 & _M32
_C2 = -2048144789 & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_keep(idx: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    x = (idx.to(torch.int64) & _M32) ^ (int(seed) & _M32)
    x = _mul32(x, _C1)
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _C1)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (2.0 ** -24)
    return u >= torch.tensor(p, dtype=torch.float32)


class StepDropout:
    """The masks of one training step (``stream``: a data-parallel rank's
    own stream, as the port draws it)."""

    def __init__(self, seed: int, step: int, device, p_hidden: float,
                 p_attn: float, stream=None):
        words = [int(seed) & _M32, int(step) & _M32]
        if stream is not None:
            words.append(int(stream) & _M32)
        w = np.random.SeedSequence(words).generate_state(3)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(w[0]) << 32 | int(w[1]))
        self._host = np.random.default_rng(int(w[2]))
        self.p_hidden, self.p_attn = p_hidden, p_attn

    def _apply(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(x, self.p_hidden)

    def probs_drawn(self, probs: torch.Tensor) -> torch.Tensor:
        """Attention probs of the last (CLS-only) block: a drawn mask."""
        return self._apply(probs, self.p_attn)

    def probs_hashed(self, probs: torch.Tensor) -> torch.Tensor:
        """Attention probs [B, H, L, L] of a full block: the hash mask."""
        if self.p_attn == 0.0:
            return probs
        seed = int(self._host.integers(-2**31, 2**31, dtype=np.int64))
        b, h, q, k = probs.shape
        dev = probs.device
        hq = (torch.arange(h, dtype=torch.int64, device=dev)[:, None, None]
              * q + torch.arange(q, dtype=torch.int64, device=dev)[:, None]
              ) * k + torch.arange(k, dtype=torch.int64, device=dev)
        # the index in rows of 16 batch entries: the hash's int64
        # temporaries of a whole passage batch would take gigabytes
        keep = torch.cat([hash_keep(
            torch.arange(s, min(s + 16, b), dtype=torch.int64,
                         device=dev)[:, None, None, None] * (h * q * k) + hq,
            seed, self.p_attn) for s in range(0, b, 16)])
        return torch.where(keep, probs / (1.0 - self.p_attn),
                           torch.zeros_like(probs))
