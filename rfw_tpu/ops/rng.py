"""Deterministic per-pixel RNG.

Reimplements the reference's device RNG lineage — WangHash seeding + xorshift
RandomFloat (/root/reference/RFW/backends/OptiX6Context/assets/kernels/
random.h:3-20, used at CUDART/src/Kernels.cu:385,699) — as vectorized uint32
jnp ops, so a (pixel, sampleIndex, bounce) triple always yields the same
sample sequence: frames are bit-reproducible (SURVEY §4).

Low-discrepancy sampling: instead of shipping the reference's baked 8,219-line
scrambled-Sobol blue-noise table (context/blue_noise.h), we generate a
void-and-cluster blue-noise mask at import time (cached) and combine it with
the golden-ratio (R2) sequence — toroidally shifted per pixel — which gives the
same "structured low-discrepancy for low spp" behavior with generated-not-baked
data. Enabled when ``RenderConfig.blue_noise`` and sample_index < 256
(reference Kernels.cu:698-713).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def wang_hash(s):
    """WangHash (random.h:3-10)."""
    s = jnp.asarray(s, _U32)
    s = (s ^ _U32(61)) ^ (s >> 16)
    s = s * _U32(9)
    s = s ^ (s >> 4)
    s = s * _U32(0x27D4EB2D)
    s = s ^ (s >> 15)
    return s


def random_int(seed):
    """xorshift step (random.h:12-19); returns (new_seed, bits)."""
    seed = jnp.asarray(seed, _U32)
    seed = seed ^ (seed << 13)
    seed = seed ^ (seed >> 17)
    seed = seed ^ (seed << 5)
    return seed, seed


def random_float(seed):
    """RandomFloat (random.h:20): uniform in [0,1); returns (new_seed, value)."""
    seed, bits = random_int(seed)
    return seed, bits.astype(jnp.float32) * jnp.float32(2.3283064365387e-10)


def random_floats(seed, n: int):
    """Draw ``n`` sequential uniforms; returns (new_seed, [v0..vn-1])."""
    vals = []
    for _ in range(n):
        seed, v = random_float(seed)
        vals.append(v)
    return seed, vals


def path_seed(path_index, sample_index, path_length=None):
    """Seed recipe of the shade kernel (Kernels.cu:699) / primary rays (:385)."""
    s = (jnp.asarray(path_index, _U32) * _U32(16789)
         + jnp.asarray(sample_index, _U32) * _U32(1791))
    if path_length is not None:
        s = s + jnp.asarray(path_length, _U32) * _U32(720898027)
    return wang_hash(s)


# ---------------------------------------------------------------------------
# Blue-noise mask (generated, not baked) + R2 low-discrepancy sequence
# ---------------------------------------------------------------------------

_MASK_SIZE = 128   # r2: grown from 64 (reference blue_noise.h tables are
#                    128x128; a 64² mask tiles visibly at 1080p)


@functools.lru_cache(maxsize=1)
def blue_noise_mask(size: int = _MASK_SIZE, seed: int = 0x5F3759DF) -> np.ndarray:
    """(size, size) float32 blue-noise ranks in [0,1) via void-and-cluster.

    A small, fast variant: start from white noise, iteratively rank by
    Gaussian-blurred density. Quality is adequate for Cranley–Patterson
    rotations (we only need well-distributed per-pixel toroidal shifts).
    Generation is O(size² FFTs) (~15 s at 128²), so the result is cached
    on disk under ~/.cache/rfw_tpu.
    """
    import os
    cache = os.path.join(os.path.expanduser("~"), ".cache", "rfw_tpu",
                         f"bluenoise_{size}_{seed:x}.npy")
    try:
        m = np.load(cache)
        if m.shape == (size, size):
            return m.astype(np.float32)
    except OSError:
        pass
    rng = np.random.default_rng(seed)
    n = size * size
    # Gaussian energy kernel with toroidal wrap.
    xs = np.arange(size)
    d = np.minimum(xs, size - xs).astype(np.float64)
    e1 = np.exp(-(d ** 2) / (2.0 * 1.9 ** 2))
    energy_kernel = np.outer(e1, e1)

    binary = np.zeros((size, size), dtype=bool)
    initial = rng.choice(n, size=n // 10, replace=False)
    binary.ravel()[initial] = True

    def energy(b):
        fb = np.fft.rfft2(b.astype(np.float64))
        fk = np.fft.rfft2(np.fft.ifftshift(
            np.roll(np.roll(energy_kernel, size // 2, 0), size // 2, 1)))
        return np.fft.irfft2(fb * fk, s=(size, size))

    # Phase 0: relax the initial set (swap tightest cluster into largest void).
    for _ in range(n // 10):
        e = energy(binary)
        cluster = np.unravel_index(np.argmax(np.where(binary, e, -np.inf)), e.shape)
        binary[cluster] = False
        e = energy(binary)
        void = np.unravel_index(np.argmin(np.where(binary, np.inf, e)), e.shape)
        if void == cluster:
            binary[cluster] = True
            break
        binary[void] = True

    rank = np.zeros((size, size), dtype=np.int64)
    # Phase 1: remove points tightest-first → ranks descending.
    work = binary.copy()
    count = int(work.sum())
    for r in range(count - 1, -1, -1):
        e = energy(work)
        cluster = np.unravel_index(np.argmax(np.where(work, e, -np.inf)), e.shape)
        work[cluster] = False
        rank[cluster] = r
    # Phase 2: fill remaining points largest-void-first → ranks ascending.
    work = binary.copy()
    for r in range(count, n):
        e = energy(work)
        void = np.unravel_index(np.argmin(np.where(work, np.inf, e)), e.shape)
        work[void] = True
        rank[void] = r
    out = ((rank.astype(np.float32) + 0.5) / float(n)).astype(np.float32)
    try:
        import os
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, out)
    except OSError:
        pass
    return out


# Generalized golden-ratio (R2) sequence constants (Roberts 2018, public).
_R2_ALPHA = np.array([0.7548776662466927, 0.5698402909980532], dtype=np.float64)

_STACK_DIMS = 16


def _dim_offsets(dim: int, size: int) -> tuple[int, int]:
    """Co-prime per-dimension toroidal offsets (see blue_noise_sample)."""
    ox = (dim * 59 + (dim // 2) * 31) % size
    oy = (dim * 101 + (dim // 2) * 17) % size
    return ox, oy


@functools.lru_cache(maxsize=1)
def blue_noise_stack(size: int = _MASK_SIZE,
                     dims: int = _STACK_DIMS) -> np.ndarray:
    """(size, size, dims) stack of per-dimension shifted mask copies.

    One (R, dims) ROW gather fetches every dimension's shift for a pixel
    instead of one mask[y+oy, x+ox] gather per dimension (raygen draws 4
    dims, NEE 2 more).
    """
    mask = blue_noise_mask(size)
    out = np.empty((size, size, dims), np.float32)
    for d in range(dims):
        ox, oy = _dim_offsets(d, size)
        out[:, :, d] = np.roll(mask, (-oy, -ox), axis=(0, 1))
    return out


def blue_noise_shift_row(stack, x, y):
    """Per-pixel (R, dims) shift rows from the stack — ONE row gather."""
    size = stack.shape[0]
    return stack[y % size, x % size]


def blue_noise_from_shift(shift, sample_index, dim: int):
    """R2 sample given the pixel's pre-fetched shift for ``dim``."""
    dim = int(dim)
    a = jnp.float32(_R2_ALPHA[dim % 2])
    k = (jnp.asarray(sample_index, jnp.float32)
         + jnp.float32((dim // 2) * 0.38196601))
    return jnp.mod(a * k + shift, 1.0).astype(jnp.float32)


def blue_noise_from_shift_koff(shift, sample_index, k_off, parity: int):
    """``blue_noise_from_shift`` with a precomputed — possibly TRACED —
    k offset: bitwise-equal to the static version when ``k_off`` holds
    ``np.float32((dim // 2) * 0.38196601)`` (f64 product, ONE rounding)
    and ``parity == dim % 2``. Lets a traced-depth stage body gather the
    per-depth constant from a static table instead of re-specializing
    the whole program per depth (render/integrator.py depth_t mode)."""
    a = jnp.float32(_R2_ALPHA[parity % 2])
    k = jnp.asarray(sample_index, jnp.float32) + k_off
    return jnp.mod(a * k + shift, 1.0).astype(jnp.float32)


def blue_noise_sample(mask, x, y, sample_index, dim: int):
    """Blue-noise-shifted R2 sample for pixel (x,y), sample and dimension.

    Plays the role of ``blueNoiseSampler`` (Kernels.cu:205-224):
    decorrelated per-dimension, toroidally shifted per pixel by the
    blue-noise mask so that low-spp error is high-frequency. Every
    DIMENSION gets its own mask offset (the reference scrambles per
    dimension via its ranking tiles, blue_noise.h) — one shift pair
    across all depths would correlate NEE samples across bounces.
    ``dim`` is static (compile-time), as at every call site.
    """
    size = mask.shape[0]
    dim = int(dim)
    if mask.ndim == 3:      # pre-shifted stack (blue_noise_stack)
        shift = mask[y % size, x % size, dim % mask.shape[2]]
    else:
        # co-prime per-dimension offsets decorrelate the shift fields
        ox, oy = _dim_offsets(dim, size)
        shift = mask[(y + oy) % size, (x + ox) % size]
    return blue_noise_from_shift(shift, sample_index, dim)
