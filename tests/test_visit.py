"""Visit-list intersector (ops/visit_intersect.py) parity vs brute force.

SURVEY §4 oracle pattern: traversal == brute-force intersect on random
scenes. Runs the Pallas (Triton) kernel in interpret mode on the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rfw_tpu.config import RenderConfig
from rfw_tpu.ops import traverse, visit_intersect
from rfw_tpu.render import scene_data
from rfw_tpu.scene.lights import pack_lights
from rfw_tpu.scene.materials import MaterialList
from rfw_tpu.scene.mesh import build_triangles


@pytest.fixture(scope="module")
def soup_scene():
    rng = np.random.default_rng(7)
    nt = 800
    centers = rng.uniform(-10, 10, (16, 3))
    tri_c = centers[rng.integers(0, 16, nt)] + rng.normal(0, 1.2, (nt, 3))
    verts = (tri_c[:, None, :] + rng.normal(0, 0.35, (nt, 3, 3))).astype(
        np.float32)
    soa = build_triangles(verts.reshape(-1, 3),
                          np.arange(nt * 3).reshape(nt, 3))
    inst = scene_data.InstancedMesh(
        triangles=soa, transform=np.eye(4, dtype=np.float32),
        instance_id=0, mesh_slot=0)
    cfg = RenderConfig()
    scene = scene_data.build_device_scene(
        [inst], MaterialList().generate_device_materials(),
        pack_lights([], [], [], []), None, None, cfg)
    scene.pop("_bvh_host")
    scene.pop("_pack_host", None)
    scene = jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, scene)
    return scene, cfg


def _rays(n, seed=0, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(n, 1e30, np.float32)
    tm[rng.random(n) < dead_frac] = 0.0
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)


def _brute(scene, o, d, cfg):
    tris = (scene["tri_vertices"][:, 0],
            scene["tri_vertices"][:, 1] - scene["tri_vertices"][:, 0],
            scene["tri_vertices"][:, 2] - scene["tri_vertices"][:, 0])
    return traverse.brute_force_closest(o, d, tris, t_epsilon=cfg.t_epsilon)


def test_visit_closest_matches_brute(soup_scene):
    scene, cfg = soup_scene
    o, d, tm = _rays(1024)
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg,
                                                    t_max=tm)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_b = jnp.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    t_p, prim_p = np.asarray(t_p), np.asarray(prim_p)
    t_b, prim_b = np.asarray(t_b), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999
    terr = np.abs(t_p[both] - t_b[both])
    assert (terr / np.maximum(t_b[both], 1e-6)).max() < 1e-4


def test_visit_any_hit_matches_brute(soup_scene):
    scene, cfg = soup_scene
    o, d, _ = _rays(1024, seed=3, dead_frac=0.0)
    rng = np.random.default_rng(5)
    dist = np.full(1024, 6.0, np.float32)
    dist[rng.random(1024) < 0.3] = 0.0
    dist = jnp.asarray(dist)
    occ = np.asarray(visit_intersect.any_hit(scene, o, d, dist, cfg))
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    occ_b = np.asarray((prim_b >= 0) & (np.asarray(t_b) < np.asarray(dist)))
    assert (occ == occ_b).all()


def test_visit_overflow_recull_passes(soup_scene, monkeypatch):
    """A tiny visit cap forces the watermark recull path on every block —
    results must stay exactly brute-force-correct."""
    scene, cfg = soup_scene
    monkeypatch.setattr(visit_intersect, "M_C", 2)
    o, d, tm = _rays(512, seed=13, dead_frac=0.2)
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg,
                                                    t_max=tm)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_b = jnp.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    prim_p, prim_b = np.asarray(prim_p), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999


def test_visit_heterogeneous_finish_passes(monkeypatch):
    """Blocks that finish their recull walk on DIFFERENT passes: a block
    finishing early must keep its committed hits while later passes run
    for other blocks (regression: passes after a block finished returned
    (t=0, slot=-1) and "0 < best_t" clobbered its results on bounce
    streams; homogeneous-finish tests never caught it).

    Scene: a tube of inward-facing rings along +x (axis rays cross every
    ring's cell but miss its triangles — the horizon never tightens, so
    block 1 walks MANY passes at M_C=2) + a standalone near quad that
    block 0 hits on pass 1."""
    monkeypatch.setattr(visit_intersect, "M_C", 2)
    rng = np.random.default_rng(31)
    tris = []
    # 16 rings x 64 triangles at radius 2 around the x axis
    for i in range(16):
        x = 4.0 + 2.0 * i
        ang0 = rng.random(64) * 2 * np.pi
        for a in ang0:
            c = np.array([x, 2.0 * np.cos(a), 2.0 * np.sin(a)])
            v = c[None] + rng.normal(0, 0.15, (3, 3))
            tris.append(v)
    # far end-cap the axis rays actually hit
    tris.append(np.array([[40.0, -3, -3], [40.0, 6, -3], [40.0, -3, 6]]))
    # standalone near quad for block 0 (off to the side)
    tris.append(np.array([[0, -60, -3], [0, -54, -3], [0, -60, 3]]))
    tris.append(np.array([[0, -54, -3], [0, -54, 3], [0, -60, 3]]))
    verts = np.stack(tris).astype(np.float32)
    nt = verts.shape[0]
    soa = build_triangles(verts.reshape(-1, 3),
                          np.arange(nt * 3).reshape(nt, 3))
    inst = scene_data.InstancedMesh(
        triangles=soa, transform=np.eye(4, dtype=np.float32),
        instance_id=0, mesh_slot=0)
    cfg = RenderConfig()
    scene = scene_data.build_device_scene(
        [inst], MaterialList().generate_device_materials(),
        pack_lights([], [], [], []), None, None, cfg)
    scene.pop("_bvh_host")
    scene.pop("_pack_host", None)
    scene = jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, scene)

    # block 0: rays hitting the standalone quad immediately
    o0 = np.tile([[0.5, -57.0, 0.0]], (256, 1)) + rng.normal(
        0, 0.2, (256, 3))
    d0 = np.tile([[-1.0, 0.0, 0.0]], (256, 1)) + rng.normal(
        0, 0.01, (256, 3))
    # block 1: axis rays down the tube (cross all ring cells, hit the cap)
    o1 = np.tile([[0.0, 0.0, 0.0]], (256, 1)) + rng.normal(
        0, 0.05, (256, 3))
    d1 = np.tile([[1.0, 0.0, 0.0]], (256, 1)) + rng.normal(
        0, 0.001, (256, 3))
    o = np.concatenate([o0, o1]).astype(np.float32)
    d = np.concatenate([d0, d1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    # sort=False keeps the two engineered blocks intact
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg,
                                                    sort=False)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_p, prim_b = np.asarray(prim_p), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999


def test_visit_super_granularity(soup_scene):
    """'super' granule mode (SUPER_G cells per DMA/visit) stays exact."""
    import dataclasses
    scene, cfg = soup_scene
    cfg_s = dataclasses.replace(cfg, visit_granularity="super")
    o, d, tm = _rays(1024, seed=21)
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg_s,
                                                    t_max=tm)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_b = jnp.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    prim_p, prim_b = np.asarray(prim_p), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999


def test_visit_coherent_unsorted(soup_scene):
    """sort=False path (pre-sorted coherent streams) stays exact."""
    scene, cfg = soup_scene
    n = 256
    rng = np.random.default_rng(11)
    o = np.full((n, 3), -20.0, np.float32) + rng.normal(0, 0.5, (n, 3))
    d = np.tile([[1.0, 1.0, 1.0]], (n, 1)) + rng.normal(0, 0.05, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.asarray(o.astype(np.float32))
    d = jnp.asarray(d.astype(np.float32))
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg,
                                                    sort=False)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    assert (np.asarray(prim_p) == np.asarray(prim_b)).mean() > 0.999


def test_visit_envelope_enum_matches_brute(soup_scene):
    """coherent=True (per-BLOCK envelope enumeration) must stay exact —
    conservative lists can only ADD visits, never lose the closest hit."""
    scene, cfg = soup_scene
    o, d, tm = _rays(1024, seed=11, dead_frac=0.2)
    t_p, prim_p, _, _ = visit_intersect.closest_hit(
        scene, o, d, cfg, t_max=tm, sort=False, coherent=True)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_b = jnp.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    t_p, prim_p = np.asarray(t_p), np.asarray(prim_p)
    t_b, prim_b = np.asarray(t_b), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999
    terr = np.abs(t_p[both] - t_b[both])
    assert (terr / np.maximum(t_b[both], 1e-6)).max() < 1e-4


@pytest.mark.parametrize("treelet_size", [48, 24])
def test_visit_k_not_multiple_of_chunk(treelet_size):
    """Cells of K triangles with K % KC != 0 (or K < KC): the wrapper pads
    the Woop planes with never-hit lanes; results stay brute-force exact."""
    import dataclasses
    rng = np.random.default_rng(17)
    nt = 300
    tri_c = rng.uniform(-6, 6, (nt, 3))
    verts = (tri_c[:, None, :] + rng.normal(0, 0.6, (nt, 3, 3))).astype(
        np.float32)
    soa = build_triangles(verts.reshape(-1, 3),
                          np.arange(nt * 3).reshape(nt, 3))
    inst = scene_data.InstancedMesh(
        triangles=soa, transform=np.eye(4, dtype=np.float32),
        instance_id=0, mesh_slot=0)
    cfg = dataclasses.replace(RenderConfig(), treelet_size=treelet_size)
    scene = scene_data.build_device_scene(
        [inst], MaterialList().generate_device_materials(),
        pack_lights([], [], [], []), None, None, cfg)
    scene.pop("_bvh_host")
    scene.pop("_pack_host", None)
    scene = jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, scene)
    assert scene["treelets"]["wplanes"].shape[2] == treelet_size
    assert treelet_size % visit_intersect.KC != 0
    o, _, tm = _rays(512, seed=23)
    aim = rng.uniform(-5, 5, (512, 3)).astype(np.float32) - np.asarray(o)
    d = jnp.asarray(aim / np.linalg.norm(aim, axis=1, keepdims=True))
    t_p, prim_p, _, _ = visit_intersect.closest_hit(scene, o, d, cfg,
                                                    t_max=tm)
    t_b, prim_b, _, _ = _brute(scene, o, d, cfg)
    prim_b = jnp.where((t_b < tm) & (prim_b >= 0), prim_b, -1)
    prim_p, prim_b = np.asarray(prim_p), np.asarray(prim_b)
    assert ((prim_p >= 0) == (prim_b >= 0)).all()
    assert (prim_p >= 0).sum() > 50
    both = (prim_p >= 0) & (prim_b >= 0)
    assert (prim_p[both] == prim_b[both]).mean() > 0.999


def test_block_entries_matches_numpy():
    """The plain-jnp enumeration against a NumPy per-block minimum of the
    per-ray slab entry over crossed cells."""
    rng = np.random.default_rng(29)
    nb, t = 3, 40
    block = visit_intersect.BLOCK
    o = rng.uniform(-5, 5, (nb * block, 3)).astype(np.float32)
    d = rng.normal(size=(nb * block, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::97, 0] = 0.0                       # axis-parallel rays
    tm = rng.uniform(0.5, 20.0, nb * block).astype(np.float32)
    tm[::5] = 0.0                          # dead lanes cross nothing
    lo = rng.uniform(-6, 5, (t, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, (t, 3)).astype(np.float32)
    bounds8 = np.concatenate([lo.T, hi.T, np.zeros((2, t), np.float32)])
    rays8 = visit_intersect._pack_rays8(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tm))
    got = np.asarray(visit_intersect.block_entries(rays8,
                                                   jnp.asarray(bounds8)))

    safe = np.where(np.abs(d) < 1e-12, np.where(d < 0, -1e-12, 1e-12), d)
    inv = (1.0 / safe)[:, None, :]
    t1 = (lo[None] - o[:, None, :]) * inv
    t2 = (hi[None] - o[:, None, :]) * inv
    ent = np.maximum(np.minimum(t1, t2).max(axis=2), 0.0)
    ext = np.maximum(t1, t2).min(axis=2)
    crossed = ent < np.minimum(ext, tm[:, None])
    want = np.where(crossed, ent, 1e30).reshape(nb, block, t).min(axis=1)
    assert got.shape == (nb, t)
    assert (got >= 1e30).sum() == (want >= 1e30).sum()
    np.testing.assert_allclose(got, want, rtol=1e-6)
