"""Two-level TLAS/BLAS vs flattened-world-space oracle (SURVEY §2.4 #24)."""

import jax.numpy as jnp
import numpy as np

from rfw_tpu.bvh.tlas import build_tlas, trace_tlas
from rfw_tpu.ops import traverse


def _mesh(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * scale
    return np.stack([
        v0, v0 + rng.uniform(-.3, .3, (n, 3)).astype(np.float32),
        v0 + rng.uniform(-.3, .3, (n, 3)).astype(np.float32)], 1)


def _xform(t, s=1.0, angle=0.0):
    c, sn = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                         np.float32) * s
    m[:3, 3] = t
    return m


def _scene():
    meshes = [_mesh(200, 1), _mesh(150, 2, scale=0.5)]
    instances = [
        (0, _xform([0, 0, 0])),
        (0, _xform([3, 0.5, 0], s=0.7, angle=0.8)),   # shared BLAS
        (1, _xform([-3, 0, 1], s=1.5, angle=-0.4)),
    ]
    return meshes, instances


def _flatten(meshes, instances):
    parts = []
    inst_of = []
    prim_of = []
    for idx, (mi, m) in enumerate(instances):
        v = meshes[mi] @ m[:3, :3].T + m[:3, 3]
        parts.append(v.astype(np.float32))
        inst_of.append(np.full(len(v), idx, np.int32))
        prim_of.append(np.arange(len(v), dtype=np.int32))
    verts = np.concatenate(parts)
    return verts, np.concatenate(inst_of), np.concatenate(prim_of)


def _rays(n=192, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_tlas_matches_flattened_oracle():
    meshes, instances = _scene()
    tlas = build_tlas(meshes, instances)
    o, d = _rays()
    t, inst, prim, u, v = trace_tlas(tlas, o, d)

    verts, inst_of, prim_of = _flatten(meshes, instances)
    tris = (jnp.asarray(verts[:, 0]),
            jnp.asarray(verts[:, 1] - verts[:, 0]),
            jnp.asarray(verts[:, 2] - verts[:, 0]))
    t_ref, flat_prim, _, _ = traverse.brute_force_closest(o, d, tris)

    t, inst, prim = np.asarray(t), np.asarray(inst), np.asarray(prim)
    t_ref, flat_prim = np.asarray(t_ref), np.asarray(flat_prim)
    hit_a, hit_b = inst >= 0, flat_prim >= 0
    assert (hit_a == hit_b).all()
    # world-space t parity despite non-uniform instance scaling
    assert np.allclose(t[hit_a], t_ref[hit_b], rtol=2e-4, atol=2e-4)
    # (instance, mesh-local prim) must identify the same triangle
    both = hit_a & hit_b
    agree = ((inst[both] == inst_of[flat_prim[both]])
             & (prim[both] == prim_of[flat_prim[both]]))
    assert agree.mean() > 0.98   # ties on overlapping surfaces may differ


def test_tlas_refit_moves_instances_without_rebuild():
    meshes, instances = _scene()
    tlas = build_tlas(meshes, instances)
    blas_ids = [id(b) for b in tlas.blas_list]

    # move instance 1 far away; refit only
    new_t = [m for _, m in instances]
    new_t[1] = _xform([30, 0, 0])
    tlas.refit(np.stack(new_t))
    assert [id(b) for b in tlas.blas_list] == blas_ids  # BLASes untouched

    o, d = _rays(seed=9)
    t, inst, prim, _, _ = trace_tlas(tlas, o, d)
    # oracle with the new transforms
    verts, inst_of, prim_of = _flatten(
        meshes, list(zip([m for m, _ in instances], new_t)))
    tris = (jnp.asarray(verts[:, 0]),
            jnp.asarray(verts[:, 1] - verts[:, 0]),
            jnp.asarray(verts[:, 2] - verts[:, 0]))
    t_ref, flat_prim, _, _ = traverse.brute_force_closest(o, d, tris)
    hit_a = np.asarray(inst) >= 0
    hit_b = np.asarray(flat_prim) >= 0
    assert (hit_a == hit_b).all()
    assert np.allclose(np.asarray(t)[hit_a], np.asarray(t_ref)[hit_b],
                       rtol=2e-4, atol=2e-4)


def test_shared_blas_instances():
    meshes, instances = _scene()
    tlas = build_tlas(meshes, instances)
    # instances 0 and 1 share mesh 0's BLAS object
    assert tlas.inst_blas[0] == tlas.inst_blas[1]
    assert len(tlas.blas_list) == 2


def test_tlas_engine_intersector_matches_bvh():
    """Engine-level wiring: megakernel with intersector='tlas' renders the
    same image as the flattened 4-wide BVH intersector (config.use_tlas
    builds the two-level tables into the device scene)."""
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus, create_engine
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    import rfw_tpu

    def render(intersector):
        cfg = RenderConfig(blue_noise=False, max_path_length=1,
                           russian_roulette=False, use_tlas=True)
        eng = create_engine("megakernel", cfg)
        ml = MaterialList()
        ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]),
                            roughness=1.0))
        ml.add(HostMaterial(color=np.array([6.0, 5.0, 4.0])))  # lamp
        floor = make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0)
        block = make_quad([0, 0, -1], [0, 1, 1.5], 2, 2, 0)
        lamp = make_quad([0, -1, 0], [0, 4, 0], 2, 2, 1)
        eng.set_mesh(0, floor.triangles())
        eng.set_mesh(1, block.triangles())
        eng.set_mesh(2, lamp.triangles())
        eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
        # two instances share mesh 1's BLAS, one rotated+scaled
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [-2.0, 0.0, 0.5]
        eng.set_instance(1, 1, m)
        c, s = np.cos(0.6), np.sin(0.6)
        m2 = np.eye(4, dtype=np.float32)
        m2[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                              np.float32) * 0.8
        m2[:3, 3] = [2.0, 0.3, 0.0]
        eng.set_instance(2, 1, m2)
        eng.set_instance(3, 2, np.eye(4, dtype=np.float32))
        eng.set_materials(ml.generate_device_materials())
        from rfw_tpu.scene.lights import pack_lights
        eng.set_lights(pack_lights([], [], [], []))
        eng.set_setting("intersector", intersector)
        cam = rfw_tpu.Camera()
        cam.resize(40, 40)
        cam.fov = 55
        cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
        eng.resize(40, 40)
        return eng.render_frame(cam.get_view().as_pytree(),
                                RenderStatus.RESET, samples=4)

    a = render("bvh")
    b = render("tlas")
    assert np.isfinite(b).all()
    assert a.mean() > 1e-4            # scene actually renders
    assert np.abs(a - b).max() < 1e-4  # same hits, same shading


def test_tlas_switch_after_build_rebuilds_tables():
    """Selecting 'tlas' AFTER the scene was built WITHOUT use_tlas must
    force a full rebuild (the setting implies the config flag, and the
    refit shortcut — keyed on _anim_key — cannot add scene['tlas'] to
    the old scene; regression: KeyError 'tlas' at trace time)."""
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus, create_engine
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    from rfw_tpu.scene.lights import PointLight, pack_lights
    import rfw_tpu

    cfg = RenderConfig(blue_noise=False, max_path_length=1)   # no use_tlas
    eng = create_engine("megakernel", cfg)
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([1.0, 4.0, -1.0], np.float32),
                        radiance=np.array([30.0, 30.0, 30.0],
                                          np.float32))], [], []))
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    cam = rfw_tpu.Camera()
    cam.resize(32, 32)
    cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
    eng.resize(32, 32)
    view = cam.get_view().as_pytree()
    a = np.asarray(eng.render_frame(view, RenderStatus.RESET, samples=1))
    eng.set_setting("intersector", "tlas")      # post-build switch
    b = np.asarray(eng.render_frame(view, RenderStatus.RESET, samples=1))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_tlas_instance_move_fast_path(monkeypatch):
    """Moving an instance under the TLAS intersector must NOT trigger a
    full device-scene rebuild — only plane re-transform + TLAS refit —
    and must render the same image as a freshly-built scene."""
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus, create_engine
    from rfw_tpu.render import scene_data as sd
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    from rfw_tpu.scene.lights import pack_lights
    import rfw_tpu

    def xf(t):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        return m

    def build(tr):
        cfg = RenderConfig(blue_noise=False, max_path_length=1,
                           russian_roulette=False, use_tlas=True)
        eng = create_engine("megakernel", cfg)
        ml = MaterialList()
        ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
        ml.add(HostMaterial(color=np.array([6.0, 5.0, 4.0])))
        eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
        eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2,
                                  0).triangles())
        eng.set_mesh(2, make_quad([0, -1, 0], [0, 4, 0], 2, 2,
                                  1).triangles())
        eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
        eng.set_instance(1, 1, tr)
        eng.set_instance(2, 2, np.eye(4, dtype=np.float32))
        eng.set_materials(ml.generate_device_materials())
        eng.set_lights(pack_lights([], [], [], []))
        eng.set_setting("intersector", "tlas")
        cam = rfw_tpu.Camera()
        cam.resize(40, 40)
        cam.fov = 55
        cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
        eng.resize(40, 40)
        return eng, cam

    eng, cam = build(xf([-1.5, 0, 0.5]))
    eng.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                     samples=2)

    # move the instance; a full rebuild from here on is a test failure
    calls = {"n": 0}
    real_build = sd.build_device_scene

    def counting_build(*a, **k):
        calls["n"] += 1
        return real_build(*a, **k)

    monkeypatch.setattr(sd, "build_device_scene", counting_build)
    eng.set_instance(1, 1, xf([1.5, 0.3, 0.0]))
    moved = eng.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                             samples=2)
    assert calls["n"] == 0, "instance move took the full-rebuild path"

    eng2, cam2 = build(xf([1.5, 0.3, 0.0]))
    fresh = eng2.render_frame(cam2.get_view().as_pytree(),
                              RenderStatus.RESET, samples=2)
    assert np.abs(np.asarray(moved) - np.asarray(fresh)).max() < 1e-4


def test_flagship_instance_move_no_rebuild(monkeypatch):
    """An instance MOVE on the flagship
    (visit) engine costs a jitted device refresh, not a flatten+rebuild,
    and renders exactly like a fresh build. (Rigid moves keep the fixed
    cell membership tight, so cull quality is preserved without a
    TLAS-table indirection.)"""
    import rfw_tpu
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus, create_engine
    from rfw_tpu.render import scene_data as sd
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    from rfw_tpu.scene.lights import PointLight, pack_lights

    def engine():
        cfg = RenderConfig(blue_noise=False, max_path_length=1,
                           russian_roulette=False)
        eng = create_engine("megakernel", cfg)
        ml = MaterialList()
        ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]),
                            roughness=1.0))
        eng.set_materials(ml.generate_device_materials())
        eng.set_lights(pack_lights(
            [], [PointLight(position=np.array([1, 4, -1], np.float32),
                            radiance=np.array([30, 30, 30], np.float32))],
            [], []))
        eng.set_setting("intersector", "visit")
        eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8,
                                  0).triangles())
        eng.set_mesh(1, make_quad([0, 0, -1], [0, 1, 1.5], 2, 2,
                                  0).triangles())
        cam = rfw_tpu.Camera()
        cam.resize(40, 40)
        cam.look_at([0, 2.5, -5.0], [0, 0.8, 0.0])
        eng.resize(40, 40)
        return eng, cam

    moved = _xform([0.8, 0.3, 0.2], angle=0.5)

    eng, cam = engine()
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng.set_instance(1, 1, np.eye(4, dtype=np.float32))
    eng.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                     samples=1)

    calls = {"n": 0}
    real = sd.build_device_scene

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(sd, "build_device_scene", counting)
    eng.set_instance(1, 1, moved)
    img_moved = np.asarray(eng.render_frame(
        cam.get_view().as_pytree(), RenderStatus.RESET, samples=2))
    assert calls["n"] == 0, "instance move took the full-rebuild path"
    assert getattr(eng, "_device_refit", None) is not None

    eng2, cam2 = engine()
    eng2.set_instance(0, 0, np.eye(4, dtype=np.float32))
    eng2.set_instance(1, 1, moved)
    fresh = np.asarray(eng2.render_frame(
        cam2.get_view().as_pytree(), RenderStatus.RESET, samples=2))
    rmse = float(np.sqrt(((img_moved - fresh) ** 2).mean()))
    assert rmse < 1e-3, rmse
    assert img_moved.mean() > 1e-4


def test_tlas_touched_compaction_many_instances(monkeypatch):
    """Instance-scaling structure: with many off-ray
    instances, the tlas intersector's touched-compaction while_loop must
    return the same hits as the flattened 4-wide BVH — including through
    the PADDED multi-chunk premask path (ray chunk shrunk below the ray
    count so the lax.scan + padding branch executes)."""
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import create_engine
    from rfw_tpu.render import intersectors as its_mod
    from rfw_tpu.render.intersectors import FACTORIES
    from rfw_tpu.scene import HostMaterial, MaterialList, make_quad
    from rfw_tpu.scene.lights import pack_lights

    cfg = RenderConfig(blue_noise=False, use_tlas=True)
    eng = create_engine("megakernel", cfg)
    ml = MaterialList()
    ml.add(HostMaterial(color=np.array([0.7, 0.6, 0.5]), roughness=1.0))
    eng.set_materials(ml.generate_device_materials())
    eng.set_lights(pack_lights([], [], [], []))
    eng.set_mesh(0, make_quad([0, 0, -1], [0, 0, 0], 1.5, 1.5,
                              0).triangles())
    # 5x5 grid of quads; camera rays below only cross the middle columns
    for i in range(25):
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = (i % 5 - 2) * 4.0
        m[1, 3] = (i // 5 - 2) * 4.0
        eng.set_instance(i, 0, m)
    eng.set_setting("intersector", "tlas")
    eng.resize(8, 8)
    eng.update()

    rng = np.random.default_rng(3)
    n = 200
    o = np.tile(np.array([[0.0, 0.0, -8.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5            # forward, narrow spread
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    ref = FACTORIES["bvh"](cfg)
    t_ref, p_ref, u_ref, v_ref = ref.closest(eng._scene, o, d)
    occ_ref = ref.occluded(eng._scene, o, d, jnp.full(n, 7.5))

    monkeypatch.setattr(its_mod, "_TLAS_RAY_CHUNK", 64)  # force 4 chunks
    tl = FACTORIES["tlas"](cfg)
    t_tl, p_tl, u_tl, v_tl = tl.closest(eng._scene, o, d)
    occ_tl = tl.occluded(eng._scene, o, d, jnp.full(n, 7.5))

    assert int((np.asarray(p_ref) >= 0).sum()) > 10   # rays actually hit
    assert np.array_equal(np.asarray(p_ref), np.asarray(p_tl))
    hit = np.asarray(p_ref) >= 0
    assert np.allclose(np.asarray(t_ref)[hit], np.asarray(t_tl)[hit],
                       rtol=2e-5, atol=2e-5)
    assert np.array_equal(np.asarray(occ_ref), np.asarray(occ_tl))
