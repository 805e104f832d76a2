"""Xoshiro256++ and the rand/rand_distr sampling pipeline used by the
reference's NN weight init (reference: src/block_neural.rs:382-418 with
rand 0.8.5 + rand_distr 0.4.3 + rand_xoshiro 0.6.0, Cargo.toml:23-25).

The reference seeds one Xoshiro256PlusPlus per neuron layer from its tape
offsets and draws Xavier-uniform or Hu(He)-normal weights; bit-exact init
parity therefore needs: SplitMix64 seeding (``seed_from_u64``), the
xoshiro256++ output function, rand's ``Uniform<f64>`` / ``Standard`` /
``Open01`` float derivations, and rand_distr's ziggurat StandardNormal
(256-strip Marsaglia-Tsang tables, R=3.654152885361008796, area
V=0.00492867323399). All arithmetic below follows those crates' published
algorithms at f64 precision; the ziggurat tables are regenerated from the
standard recurrence (x[0] = V/pdf(R), f(x_{i+1}) = f(x_i) + V/x_i) rather
than copied.

Everything here is plain integer/f64 math on a few hundred samples per
layer — host-side init code, not a device kernel.

The port's own copy of fwumious_wabbit_tpu/ops/xoshiro.py (numpy only),
held to the original by tests/test_torch_nn_init.py.
"""

from __future__ import annotations

import math

import numpy as np

_M64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


def _splitmix64_next(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, z ^ (z >> 31)


class Xoshiro256PlusPlus:
    """xoshiro256++ 1.0 with rand_xoshiro's SplitMix64 ``seed_from_u64``."""

    def __init__(self, seed_u64: int):
        s = seed_u64 & _M64
        self.s = []
        for _ in range(4):
            s, z = _splitmix64_next(s)
            self.s.append(z)

    def next_u64(self) -> int:
        s0, s1, s2, s3 = self.s
        result = (_rotl((s0 + s3) & _M64, 23) + s0) & _M64
        t = (s1 << 17) & _M64
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
        self.s = [s0, s1, s2, s3]
        return result

    # -- rand 0.8 float distributions -----------------------------------

    def standard_f64(self) -> float:
        """``rng.gen::<f64>()`` (Standard): 53 bits in [0, 1)."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def open01_f64(self) -> float:
        """rand's Open01: 52 bits + the half-ulp offset, in (0, 1)."""
        frac = self.next_u64() >> 12
        # (1.0 + frac·2⁻⁵²) − (1 − ε/2) computed exactly
        return frac * (1.0 / (1 << 52)) + (1.0 / (1 << 53))

    def uniform(self, low: float, high: float) -> float:
        """rand 0.8 ``Uniform::<f64>::new(low, high)`` single sample:
        value0_1 · scale + low with value0_1 = ((bits >> 12) | exp1)−1."""
        scale = high - low
        value1_2 = np.uint64((self.next_u64() >> 12) | (1023 << 52)).view(
            np.float64
        )
        return float(value1_2 - 1.0) * scale + low


# -- ziggurat StandardNormal (rand_distr 0.4) ------------------------------

ZIG_NORM_R = 3.654152885361008796  # rand_distr's published R for N=256
_ZIG_NORM_V = 0.00492867323399  # area per strip (Marsaglia & Tsang 2000)


def _build_norm_tables():
    """Regenerate ZIG_NORM_X / ZIG_NORM_F (257 entries each) from the
    standard recurrence at f64: x[0] = v/f(r), x[1] = r,
    x[i+1] = f⁻¹(f(x[i]) + v/x[i]), x[256] = 0; f(x) = exp(−x²/2)."""

    def pdf(x):
        return math.exp(-x * x / 2.0)

    def pdf_inv(y):
        return math.sqrt(-2.0 * math.log(y))

    x = [0.0] * 257
    x[0] = _ZIG_NORM_V / pdf(ZIG_NORM_R)
    x[1] = ZIG_NORM_R
    for i in range(2, 256):
        y = pdf(x[i - 1]) + _ZIG_NORM_V / x[i - 1]
        x[i] = pdf_inv(y)
    x[256] = 0.0
    f = [pdf(v) for v in x]
    return x, f


ZIG_NORM_X, ZIG_NORM_F = _build_norm_tables()


def standard_normal(rng: Xoshiro256PlusPlus) -> float:
    """rand_distr 0.4 StandardNormal for f64 (ziggurat)."""
    x_tab, f_tab = ZIG_NORM_X, ZIG_NORM_F
    while True:
        bits = rng.next_u64()
        i = bits & 0xFF
        f = (bits >> 11) * (1.0 / (1 << 53))
        u = 2.0 * f - 1.0
        x = u * x_tab[i]
        if abs(x) < x_tab[i + 1]:
            return x
        if i == 0:
            # tail: Marsaglia's method with Open01 draws
            xx, yy = 1.0, 0.0
            while -2.0 * yy < xx * xx:
                x_ = rng.open01_f64()
                y_ = rng.open01_f64()
                xx = math.log(x_) / ZIG_NORM_R
                yy = math.log(y_)
            return xx - ZIG_NORM_R if u < 0.0 else ZIG_NORM_R - xx
        if f_tab[i + 1] + (f_tab[i] - f_tab[i + 1]) * rng.standard_f64() < math.exp(
            -x * x / 2.0
        ):
            return x


def normal(rng: Xoshiro256PlusPlus, mean: float, std_dev: float) -> float:
    """rand_distr ``Normal::new(mean, std_dev)`` sample."""
    return mean + std_dev * standard_normal(rng)
