"""RNG determinism + uniformity (reference random.h lineage)."""

import jax.numpy as jnp
import numpy as np

from rfw_tpu.ops import rng


def test_wang_hash_deterministic():
    a = rng.wang_hash(jnp.arange(1024, dtype=jnp.uint32))
    b = rng.wang_hash(jnp.arange(1024, dtype=jnp.uint32))
    assert (np.asarray(a) == np.asarray(b)).all()
    # avalanche: nearby seeds decorrelate
    assert len(np.unique(np.asarray(a))) == 1024


def test_random_float_range_and_uniformity():
    seed = rng.wang_hash(jnp.arange(1 << 14, dtype=jnp.uint32))
    seed, v = rng.random_float(seed)
    v = np.asarray(v)
    assert (v >= 0).all() and (v < 1).all()
    assert abs(v.mean() - 0.5) < 0.01
    hist, _ = np.histogram(v, bins=16, range=(0, 1))
    assert hist.min() > 0.7 * v.size / 16


def test_sequence_advances():
    seed = rng.path_seed(jnp.uint32(7), 3)
    seed, vals = rng.random_floats(seed, 4)
    assert len(set(float(x) for x in vals)) == 4


def test_blue_noise_mask_properties():
    m = rng.blue_noise_mask(32)
    assert m.shape == (32, 32)
    # every rank appears exactly once (it's a permutation / dither matrix)
    assert len(np.unique(m)) == 32 * 32
    # blue noise: neighboring ranks should differ a lot on average
    d = np.abs(np.diff(m, axis=0)).mean()
    assert d > 0.25  # white noise gives ~0.33; ordered gradient ~1/1024


def test_blue_noise_error_is_high_frequency():
    """The sampler's claimed property, measured: at
    4 spp the per-pixel integration error must concentrate at HIGH
    spatial frequencies — after a low-pass blur, blue-noise error energy
    should be far below white noise's (which is flat-spectrum)."""
    import jax.numpy as jnp

    mask = rng.blue_noise_mask()
    size = 128
    yy, xx = np.mgrid[0:size, 0:size]
    x = jnp.asarray(xx.ravel().astype(np.int32))
    y = jnp.asarray(yy.ravel().astype(np.int32))
    pid = jnp.asarray((yy * size + xx).ravel().astype(np.uint32))
    spp = 4

    est_bn = sum(np.asarray(rng.blue_noise_sample(jnp.asarray(mask), x, y,
                                                  s, 0))
                 for s in range(spp)) / spp
    est_wn = sum(np.asarray(rng.random_float(rng.path_seed(pid, s, 0))[1])
                 for s in range(spp)) / spp
    err_bn = (est_bn - 0.5).reshape(size, size)
    err_wn = (est_wn - 0.5).reshape(size, size)

    # toroidal Gaussian low-pass (sigma 2 px)
    f = np.fft.fftfreq(size)
    gx = np.exp(-2 * (np.pi * f * 2.0) ** 2)
    lowpass = np.outer(gx, gx)

    def blurred_rms(e):
        return float(np.sqrt(np.mean(np.abs(
            np.fft.ifft2(np.fft.fft2(e) * lowpass)) ** 2)))

    r_bn, r_wn = blurred_rms(err_bn), blurred_rms(err_wn)
    assert r_bn < 0.5 * r_wn, (r_bn, r_wn)


def test_blue_noise_dims_decorrelated():
    """Each dimension pair gets its own toroidal shift field (round-1
    shared one pair across all depths, correlating NEE samples across
    bounces)."""
    import jax.numpy as jnp

    mask = jnp.asarray(rng.blue_noise_mask())
    size = 128
    yy, xx = np.mgrid[0:size, 0:size]
    x = jnp.asarray(xx.ravel().astype(np.int32))
    y = jnp.asarray(yy.ravel().astype(np.int32))
    s4 = np.asarray(rng.blue_noise_sample(mask, x, y, 0, 4))
    s6 = np.asarray(rng.blue_noise_sample(mask, x, y, 0, 6))
    assert not np.allclose(s4, s6)
    c = np.corrcoef(s4, s6)[0, 1]
    assert abs(c) < 0.1, c
