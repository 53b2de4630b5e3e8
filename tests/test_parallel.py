"""Multi-chip tiling: shard_map render equals the single-device render
(on the 8 virtual CPU devices configured in conftest)."""

import jax
import jax.numpy as jnp
import numpy as np

from rfw_tpu.config import RenderConfig
from rfw_tpu.parallel import make_tile_mesh
from rfw_tpu.parallel.tiles import render_tiled
from rfw_tpu.render.integrator import trace_sample
from rfw_tpu.render.intersectors import FACTORIES


def _scene_and_view(width, height):
    import __graft_entry__ as ge
    config = RenderConfig()
    engine, cam = ge._tiny_scene(width, height, config)
    return engine._scene, cam.get_view().as_pytree(), config


def test_tiled_matches_single_device():
    width, height = 32, 32
    scene, view, config = _scene_and_view(width, height)
    intersector = FACTORIES["bvh"](config)

    radiance, _, stats, _aux = jax.jit(
        lambda s, v: trace_sample(s, v, width, height, jnp.uint32(0),
                                  jnp.int32(0), config, intersector)
    )(scene, view)
    single = np.asarray(radiance)

    mesh = make_tile_mesh(8)
    frame, tstats = render_tiled(scene, view, width, height, config,
                                 intersector, samples=1, mesh=mesh)
    tiled = np.asarray(frame).reshape(-1, 3)

    assert np.allclose(single, tiled, rtol=1e-5, atol=1e-5)
    # psum'd counters equal the global count
    assert int(tstats["ray_count_0"]) == width * height


def test_tiled_multi_sample_accumulation():
    width, height = 32, 16
    scene, view, config = _scene_and_view(width, height)
    intersector = FACTORIES["bvh"](config)
    mesh = make_tile_mesh(4)
    frame, _ = render_tiled(scene, view, width, height, config,
                            intersector, samples=3, mesh=mesh)
    assert frame.shape == (height, width, 3)
    assert np.isfinite(np.asarray(frame)).all()
    assert float(jnp.mean(frame)) > 0


def _build_engine_scene(eng):
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    from rfw_tpu.scene.lights import PointLight, pack_lights
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0], np.float32))],
        [], []))
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))


def _render_engine(name, cfg, intersector=None):
    import rfw_tpu
    from rfw_tpu.render import RenderStatus, create_engine
    eng = create_engine(name, cfg)
    _build_engine_scene(eng)
    if intersector:
        eng.set_setting("intersector", intersector)
    cam = rfw_tpu.Camera()
    cam.resize(64, 48)
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    eng.resize(64, 48)
    eng.set_probe_index((20, 10))
    img = np.asarray(eng.render_frame(cam.get_view().as_pytree(),
                                      RenderStatus.RESET, samples=2))
    return img, eng


def test_n_devices_through_engine_abi():
    """RenderConfig.n_devices routes render_frame through the tile mesh —
    the product-ABI multi-chip path. Frame, stats
    and probe must match the single-device engine."""
    cfg1 = RenderConfig(blue_noise=False, max_path_length=1)
    img1, e1 = _render_engine("megakernel", cfg1)
    cfg8 = RenderConfig(blue_noise=False, max_path_length=1, n_devices=8)
    img8, e8 = _render_engine("megakernel", cfg8)
    assert np.abs(img1 - img8).max() < 1e-5
    assert e8.stats.primary_count == 64 * 48
    assert e8.stats.shadow_count > 0
    assert e1.get_probe_results() == e8.get_probe_results()


def test_n_devices_visit_intersector():
    """The flagship visit intersector (Pallas, interpret on CPU) runs
    under the 8-device mesh and matches single-device."""
    cfg1 = RenderConfig(blue_noise=False, max_path_length=1)
    img1, _ = _render_engine("megakernel", cfg1, intersector="visit")
    cfg8 = RenderConfig(blue_noise=False, max_path_length=1, n_devices=8)
    img8, _ = _render_engine("megakernel", cfg8, intersector="visit")
    assert np.abs(img1 - img8).max() < 1e-5


def test_n_devices_large_shard_bitwise():
    """Per-shard streams of >= 8 ray blocks (the multi-block visit path:
    per-launch sort-carry, multi-pass recull windows, all INSIDE the
    shard_map body) must keep the 8-device frame identical to
    single-device."""
    import rfw_tpu
    from rfw_tpu.render import RenderStatus, create_engine
    from rfw_tpu.ops import visit_intersect

    def render(cfg):
        eng = create_engine("megakernel", cfg)
        _build_engine_scene(eng)
        eng.set_setting("intersector", "visit")
        cam = rfw_tpu.Camera()
        cam.resize(160, 104)
        cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
        eng.resize(160, 104)
        return np.asarray(eng.render_frame(cam.get_view().as_pytree(),
                                           RenderStatus.RESET, samples=1))

    n_shard = 160 * 104 // 8
    pad = -(n_shard) % visit_intersect.BLOCK
    assert n_shard + pad >= 8 * visit_intersect.BLOCK  # gate engages
    img1 = render(RenderConfig(blue_noise=False, max_path_length=1))
    img8 = render(RenderConfig(blue_noise=False, max_path_length=1,
                               n_devices=8))
    assert np.abs(img1 - img8).max() < 1e-5


def test_n_devices_driver_route(monkeypatch):
    """n_devices > 1 on a wavefront-driver engine routes through
    make_driver_engine_step: the flagship compacted whole-sample program
    (per-depth lane compaction, traced chunk trips) runs PER CHIP inside
    shard_map — frame, stats and probe must match
    the single-device engine."""
    import rfw_tpu
    import rfw_tpu.parallel.tiles as tiles_mod
    from rfw_tpu.render import RenderStatus, create_engine

    calls = []
    orig = tiles_mod.make_driver_engine_step
    monkeypatch.setattr(
        tiles_mod, "make_driver_engine_step",
        lambda *a, **k: calls.append(1) or orig(*a, **k))

    def render(n_dev):
        cfg = RenderConfig(blue_noise=False, max_path_length=2,
                           n_devices=n_dev, max_rays_per_pass=1024)
        eng = create_engine("megakernel", cfg)
        eng.use_wavefront_driver = True
        _build_engine_scene(eng)
        cam = rfw_tpu.Camera()
        cam.resize(64, 48)
        cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
        eng.resize(64, 48)
        eng.set_probe_index((20, 10))
        img = np.asarray(eng.render_frame(cam.get_view().as_pytree(),
                                          RenderStatus.RESET, samples=2))
        return img, eng

    img8, e8 = render(8)
    assert calls, "n_devices path did not route through the driver step"
    img1, e1 = render(0)
    assert np.abs(img1 - img8).max() < 1e-5
    assert e8.stats.primary_count == 64 * 48
    assert e8.stats.shadow_count > 0
    assert e1.get_probe_results() == e8.get_probe_results()
