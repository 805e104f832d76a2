"""FFM weight initialization on the device — the counterpart of
fwumious_wabbit_tpu/ops/init.py.

The reference initializes FFM weights with ``merand48``, a 48-bit LCG
(reference: src/block_ffm.rs:793-829):

    state  = A·x + C  (mod 2^64),  A = 0xEECE66D5DEECE66D, C = 2^31 − 1
    value  = bitcast(((state >> 25) & 0x7FFFFF) | 127<<23) − 1.0  ∈ [0, 1)

The JAX package emulates the 64-bit product with 16-bit limbs (no uint64
without x64); torch has int64, whose product wraps mod 2^64, so ``A`` is
used as its two's-complement value. An arithmetic ``>>`` of a negative
state shifts in ones, which the 23-bit mask removes. The tables are filled
in blocks, so a 2^25-weight table never needs all its int64 indices at once.
"""

from __future__ import annotations

import numpy as np
import torch

_A = 0xEECE66D5DEECE66D - (1 << 64)  # as a signed int64
_C = 2147483647
_BLOCK = 1 << 22  # weights initialized per block


def merand48(x: torch.Tensor) -> torch.Tensor:
    """merand48 of int64 indices → f32 in [0, 1)."""
    state = x.long() * _A + _C  # wraps mod 2^64
    bits = ((state >> 25) & 0x7FFFFF) | (127 << 23)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _fill(padded: int, n: int, device, block_fn) -> torch.Tensor:
    """``[padded]`` f32: ``block_fn(i)`` at the indices ``i < n``, 0 after."""
    out = torch.zeros(padded, dtype=torch.float32, device=device)
    for lo in range(0, min(n, padded), _BLOCK):
        hi = min(lo + _BLOCK, n, padded)
        out[lo:hi] = block_fn(torch.arange(lo, hi, dtype=torch.int64,
                                           device=device))
    return out


def ffm_init_default(n: int, k: int, padded: int, device=None) -> torch.Tensor:
    """``(merand48(n + i) − 0.5)/√k/50`` for ``i < n`` (``n + i`` as u32),
    zero padding to ``padded`` (reference: src/block_ffm.rs:796-806)."""
    scale = float(1.0 / np.sqrt(k) / 50.0)
    return _fill(padded, n, device,
                 lambda i: (merand48((i + n) & 0xFFFFFFFF) - 0.5) * scale)


def ffm_init_band(n: int, padded: int, init_width: float, init_zero_band: float,
                  init_center: float, device=None) -> torch.Tensor:
    """The center/width/zero-band scheme (reference: src/block_ffm.rs:807-822)."""
    zero_half_band = float(init_width * init_zero_band * 0.5)
    band_width = float(init_width * (1.0 - init_zero_band))

    def block(i):
        # f32, each operation rounded, in the reference's order (XLA fuses
        # some of them: the JAX package's values differ by up to 1 ulp)
        w = merand48(i) * band_width - band_width * 0.5
        w = torch.where(w > 0.0, w + zero_half_band, w - zero_half_band)
        return w + init_center

    return _fill(padded, n, device, block)
