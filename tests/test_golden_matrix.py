"""Golden matrix for the BASELINE configs.

Pins small-resolution goldens for config 2 (full PT, NEE+MIS, mirror +
diffuse, area + point lights) and config 3 (microfacet + textures +
envmap importance sampling), and checks the tiled multi-chip path
reproduces the config-2 golden. Deterministic RNG + fixed builds mean
any drift is a real estimator change — regenerate ONLY deliberately via
``python tests/golden_scenes.py --regen``."""

import os

import numpy as np
import pytest

from golden_scenes import GOLDEN_DIR, GOLDENS, render


def _check(name, engine="megakernel", n_devices=0):
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated")
    img = render(name, engine=engine, n_devices=n_devices)
    golden = np.load(path).astype(np.float32)
    rmse = float(np.sqrt(((img - golden) ** 2).mean()))
    # fp16 storage quantization is the only tolerated difference
    assert rmse < 2e-3, f"golden {name} mismatch: RMSE {rmse}"
    assert np.isfinite(img).all()


def test_config2_matches_golden():
    _check("config2_64_8spp")


def test_config3_matches_golden():
    _check("config3_64_8spp")


def test_config4_matches_golden():
    """BASELINE config 4: skinned CesiumMan rendered through the refit
    path (build at bind pose, re-skin + refit at t=0.5)."""
    _check("config4_64_8spp")


def test_config2_tiled_matches_golden():
    """BASELINE config 5 shape: the same frame sharded over the 8-device
    CPU mesh must land on the single-device golden (absolute-pixel-id
    RNG keeps the estimator tiling-invariant)."""
    _check("config2_64_8spp", n_devices=8)
