"""Deformation refit path (scene_data.refit_deformed): same-topology mesh
updates skip the SAH rebuild but must render exactly like a fresh build
(reference rebuild-vs-refit policy, top_level_bvh.cpp:17-53)."""

import numpy as np

import rfw_tpu
from rfw_tpu.config import RenderConfig
from rfw_tpu.render import RenderStatus, create_engine
from rfw_tpu.render import scene_data as sd
from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu.scene.lights import PointLight, pack_lights


def _engine(intersector="bvh", **cfg_kw):
    cfg = RenderConfig(blue_noise=False, max_path_length=1,
                       russian_roulette=False, **cfg_kw)
    eng = create_engine("megakernel", cfg)
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0], np.float32))],
        [], []))
    eng.set_setting("intersector", intersector)
    cam = rfw_tpu.Camera()
    cam.resize(40, 40)
    cam.fov = 55
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    eng.resize(40, 40)
    return eng, cam


def _render(eng, cam):
    return np.asarray(eng.render_frame(cam.get_view().as_pytree(),
                                       RenderStatus.RESET, samples=2))


def test_deform_refit_matches_fresh_build(monkeypatch):
    import pytest
    from rfw_tpu import native
    if not native.available():
        pytest.skip("native refit unavailable")

    eng, cam = _engine()
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))
    _render(eng, cam)

    calls = {"n": 0}
    real_build = sd.build_device_scene

    def counting(*a, **k):
        calls["n"] += 1
        return real_build(*a, **k)

    monkeypatch.setattr(sd, "build_device_scene", counting)
    # deform mesh 1: same topology (a 2x2 quad), moved and tilted
    eng.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                              0).triangles())
    moved = _render(eng, cam)
    assert calls["n"] == 0, "deformation took the full-rebuild path"

    eng2, cam2 = _engine()
    eng2.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng2.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                               0).triangles())
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng2.set_instance(1, 1, np.eye(4, dtype=np.float32))
    fresh = _render(eng2, cam2)
    assert np.abs(moved - fresh).max() < 1e-4
    assert moved.mean() > 1e-4


def test_refit_dense_intersector_treelet_tables(monkeypatch):
    """The refit also refreshes the treelet Woop/bounds tables the dense
    (treelet) intersector consumes."""
    import pytest
    from rfw_tpu import native
    if not native.available():
        pytest.skip("native refit unavailable")

    eng, cam = _engine(intersector="dense")
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    _render(eng, cam)
    eng.set_mesh(0, make_quad([0, 1, 0], [0.5, 0.6, 0], 8, 8,
                              0).triangles())
    moved = _render(eng, cam)

    eng2, cam2 = _engine(intersector="dense")
    eng2.set_mesh(0, make_quad([0, 1, 0], [0.5, 0.6, 0], 8, 8,
                               0).triangles())
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    fresh = _render(eng2, cam2)
    assert np.abs(moved - fresh).max() < 1e-4


def test_deform_with_tlas_matches_fresh_build():
    """A deformation while TLAS tables are in the scene must NOT take the
    flat-plane refit path (it would leave the BLAS object-space geometry
    stale): the render must equal a fresh build."""
    eng, cam = _engine(intersector="tlas", use_tlas=True)
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))
    _render(eng, cam)

    # deform mesh 1: same topology, new vertex positions
    eng.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                              0).triangles())
    moved = _render(eng, cam)

    eng2, cam2 = _engine(intersector="tlas", use_tlas=True)
    eng2.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng2.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                               0).triangles())
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng2.set_instance(1, 1, np.eye(4, dtype=np.float32))
    fresh = _render(eng2, cam2)
    assert np.abs(moved - fresh).max() < 1e-4
    assert moved.mean() > 1e-4


def test_device_refit_matches_fresh_build(monkeypatch):
    """The jitted device deformation path (scene_data.make_device_refit)
    must render like a fresh build on the flagship visit intersector —
    and must NOT take the full-rebuild path."""
    from rfw_tpu.render import scene_data as sd2

    eng, cam = _engine(intersector="visit")
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))
    _render(eng, cam)

    calls = {"n": 0}
    real_build = sd2.build_device_scene

    def counting(*a, **k):
        calls["n"] += 1
        return real_build(*a, **k)

    monkeypatch.setattr(sd2, "build_device_scene", counting)
    eng.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                              0).triangles())
    moved = _render(eng, cam)
    assert calls["n"] == 0, "deformation took the full-rebuild path"
    assert getattr(eng, "_device_refit", None) is not None, \
        "device refit did not engage"

    eng2, cam2 = _engine(intersector="visit")
    eng2.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng2.set_mesh(1, make_quad([0.4, 0.2, -1], [0.8, 1.4, 1.0], 2, 2,
                               0).triangles())
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng2.set_instance(1, 1, np.eye(4, dtype=np.float32))
    fresh = _render(eng2, cam2)
    rmse = float(np.sqrt(((moved - fresh) ** 2).mean()))
    assert rmse < 1e-3, rmse
    assert moved.mean() > 1e-4


def test_topology_change_forces_rebuild():
    eng, cam = _engine()
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    _render(eng, cam)
    # different triangle count → must NOT take the refit path; render must
    # still be correct (full rebuild)
    tris = make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles()
    import dataclasses as dc
    double = type(tris)(**{
        f.name: np.concatenate([getattr(tris, f.name)] * 2)
        for f in dc.fields(tris)})
    eng.set_mesh(0, double)
    img = _render(eng, cam)
    assert np.isfinite(img).all()


def test_instance_moves_never_hit_full_rebuild(monkeypatch):
    """Transform-only instance moves on the flagship (visit) path take the
    device refit with fresh Morton cells every call — drift-free, so the
    max_refits backstop must NOT trigger a periodic full-SAH rebuild
    (a multi-second frame hitch at bench scale). Reference analog: moves
    are a TLAS-refit, never a BLAS rebuild (top_level_bvh.cpp:17-53)."""
    from rfw_tpu.render import scene_data as sd3

    eng, cam = _engine(intersector="visit", max_refits=4)
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))
    _render(eng, cam)

    calls = {"n": 0}
    real_build = sd3.build_device_scene

    def counting(*a, **k):
        calls["n"] += 1
        return real_build(*a, **k)

    monkeypatch.setattr(sd3, "build_device_scene", counting)
    m = np.eye(4, dtype=np.float32)
    for i in range(10):                   # 2.5x past max_refits=4
        m[0, 3] = 0.1 * (i + 1)
        eng.set_instance(1, 1, m)
        eng.update()
    moved = _render(eng, cam)
    assert calls["n"] == 0, \
        f"{calls['n']} full rebuilds during transform-only moves"

    eng2, cam2 = _engine(intersector="visit")
    eng2.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng2.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0).triangles())
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng2.set_instance(1, 1, m)
    fresh = _render(eng2, cam2)
    rmse = float(np.sqrt(((moved - fresh) ** 2).mean()))
    assert rmse < 1e-3, rmse
    assert moved.mean() > 1e-4
