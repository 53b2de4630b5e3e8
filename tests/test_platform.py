"""Platform seams: the wavefront engine's intersector per JAX platform,
the compile-cache placement, the smoke run's nvidia-smi parsing, and the
card-only check (skips on the CPU)."""

import os

import jax
import numpy as np
import pytest

from rfw_tpu import _jax_setup
from rfw_tpu.render import engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform, expected", [
    ("cpu", "bvh"), ("gpu", engines.GPU_INTERSECTOR), ("metal", None)])
def test_wavefront_intersector_choice(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expected is None:
        with pytest.raises(RuntimeError, match="no wavefront intersector"):
            engines.WavefrontEngine()
        return
    eng = engines.WavefrontEngine()
    assert eng._intersector_name == expected
    assert expected in engines.FACTORIES


@pytest.mark.parametrize("env_dir", [None, "preset"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    calls = {}
    monkeypatch.setattr(_jax_setup, "_done", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        _jax_setup.setup()
        want = os.path.join(REPO, ".jax_cache")
        assert _jax_setup.CACHE_DIR == want == _jax_setup.cache_dir()
        assert calls["jax_compilation_cache_dir"] == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        d = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        _jax_setup.setup()
        assert calls == {}            # JAX reads the variable itself
        assert _jax_setup.cache_dir() == d


@pytest.mark.parametrize("text, rows", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4,
     [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
    ("NVIDIA H100 PCIe, [N/A]\n\n", [("NVIDIA H100 PCIe", "[N/A]")]),
])
def test_nvidia_smi_parser(text, rows):
    from chip_smoke import parse_gpu_query
    assert parse_gpu_query(text) == rows


@pytest.mark.parametrize("text", ["", "NVIDIA H100 80GB HBM3\n", ", 700 W"])
def test_nvidia_smi_parser_rejects(text):
    from chip_smoke import parse_gpu_query
    with pytest.raises(ValueError):
        parse_gpu_query(text)


@pytest.mark.gpu
def test_visit_matches_bvh_on_gpu(gpu_device):
    """Card-only: the compiled Triton visit kernel against bvh on a random
    soup (chip_smoke.py runs the full-width version of this check)."""
    import jax.numpy as jnp

    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import scene_data
    from rfw_tpu.render.intersectors import FACTORIES
    from rfw_tpu.scene.lights import pack_lights
    from rfw_tpu.scene.materials import MaterialList
    from rfw_tpu.scene.mesh import build_triangles

    rng = np.random.default_rng(7)
    nt = 4000
    verts = (rng.uniform(-10, 10, (nt, 1, 3))
             + rng.normal(0, 0.4, (nt, 3, 3))).astype(np.float32)
    soa = build_triangles(verts.reshape(-1, 3),
                          np.arange(nt * 3).reshape(nt, 3))
    cfg = RenderConfig()
    scene = scene_data.build_device_scene(
        [scene_data.InstancedMesh(soa, np.eye(4, dtype=np.float32), 0, 0)],
        MaterialList().generate_device_materials(),
        pack_lights([], [], [], []), None, None, cfg)
    for k in ("_bvh_host", "_pack_host", "_perm_host"):
        scene.pop(k, None)
    scene = jax.device_put(scene, gpu_device)
    o = jnp.asarray(rng.uniform(-12, 12, (1 << 16, 3)).astype(np.float32))
    d = rng.normal(size=(1 << 16, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    t_v, p_v, _, _ = FACTORIES["visit"](cfg).closest(scene, o, d)
    t_b, p_b, _, _ = FACTORIES["bvh"](cfg).closest(scene, o, d)
    assert (np.asarray(p_v) >= 0).sum() > 1000
    assert ((np.asarray(p_v) >= 0) != (np.asarray(p_b) >= 0)).mean() < 1e-3
