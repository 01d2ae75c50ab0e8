"""Digests of decoded pictures, the same on the device and on the host.

A plane's digest is the exact integer sum of its bytes read as
little-endian int16 words, each times a fixed odd weight below 2**15:
every product fits in int32 and the sum in int64, so nothing wraps, and
a change to any one word always changes the sum. The weights depend on
the plane's size alone, so the program's pictures on the card and the
reference's pictures on the host are summed alike.
"""

from __future__ import annotations

import numpy as np

_WEIGHT_SEED = 0x6D32646563


def weights(n_words: int) -> np.ndarray:
    """Odd int32 weights in [1, 2**15) for a plane of n_words int16
    words."""
    rng = np.random.default_rng([_WEIGHT_SEED, n_words])
    return (rng.integers(0, 1 << 14, n_words, dtype=np.int32) * 2 + 1)


def plane_words(shape) -> int:
    h, w = shape[-2:]
    if (h * w) % 2:
        raise ValueError(f"a plane of {h}x{w} bytes is not whole int16 "
                         f"words")
    return h * w // 2


def digest_np(plane: np.ndarray) -> int:
    """The digest of one uint8 plane [H, W] on the host."""
    words = np.ascontiguousarray(plane, np.uint8).view("<i2").reshape(-1)
    return int(np.dot(words.astype(np.int64),
                      weights(words.size).astype(np.int64)))


def picture_digests_np(y, cb, cr) -> tuple:
    return digest_np(y), digest_np(cb), digest_np(cr)


class DeviceDigest:
    """Digests of stacks of planes on a torch device, weights kept
    there: ``planes(x)`` for x uint8 [N, H, W] gives int64 [N]."""

    def __init__(self, device):
        self.device = device
        self._w = {}

    def planes(self, x):
        import torch

        n = plane_words(x.shape)
        w = self._w.get(n)
        if w is None:
            w = torch.from_numpy(weights(n)).to(self.device)
            self._w[n] = w
        words = x.contiguous().view(torch.int16).reshape(x.shape[0], n)
        return (words.to(torch.int32) * w).sum(1, dtype=torch.int64)
