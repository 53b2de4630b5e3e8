"""Seeded textured interior: the scene of the benchmark and the smoke run.

One mesh of a cut-away room (floor and two walls) filled with tessellated
boxes, UV spheres and capped cylinders of varied size — a depth-complex
mix of large occluders and small clutter — with 36 materials, each with
its own procedural RGBA texture. ``build_interior`` places 2 x 2
instances of it (303,874 triangles with the light), one emissive quad
above them as the area light, ``Skybox.test_sky()``, and a camera that
looks into all four rooms.

Everything is made in memory from ``seed``: the same seed gives the same
geometry, textures and materials; the triangle count does not depend on
the seed.
"""

from __future__ import annotations

import numpy as np

from .materials import HostMaterial
from .mesh import SceneMesh
from .texture import Texture

ROOM = np.array([20.0, 8.0, 30.0], np.float32)   # x, y (height), z
N_MATERIALS = 36
TEX_SIZE = 64
N_SPHERES, SPHERE_LAT, SPHERE_LON = 16, 24, 48
N_CYLINDERS, CYL_SEG, CYL_RINGS = 12, 48, 16
N_BOXES, BOX_SUBDIV = 68, 4
FLOOR_CELLS = (40, 60)
MESH_TRIANGLES = (2 * (FLOOR_CELLS[0] * FLOOR_CELLS[1]
                       + FLOOR_CELLS[0] * 16 + FLOOR_CELLS[1] * 16)
                  + N_SPHERES * 2 * SPHERE_LON * (SPHERE_LAT - 1)
                  + N_CYLINDERS * (2 * CYL_SEG * CYL_RINGS + 2 * CYL_SEG)
                  + N_BOXES * 6 * 2 * BOX_SUBDIV * BOX_SUBDIV)


def _grid_indices(nu: int, nv: int) -> np.ndarray:
    """Two triangles per cell of an (nu+1) x (nv+1) vertex grid."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).ravel()
    b, c, d = a + nv + 1, a + nv + 2, a + 1
    return np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])


def _patch(origin, eu, ev, nu: int, nv: int, uv_scale=(1.0, 1.0)):
    """Planar patch origin + s*eu + t*ev, s, t in [0, 1], facing eu x ev."""
    s, t = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1),
                       indexing="ij")
    s, t = s.ravel()[:, None], t.ravel()[:, None]
    pos = origin + s * eu + t * ev
    n = np.cross(eu, ev)
    n = np.broadcast_to(n / np.linalg.norm(n), pos.shape)
    uv = np.concatenate([s * uv_scale[0], t * uv_scale[1]], 1)
    return pos, n, uv, _grid_indices(nu, nv)


def _box(center, size, rot_y: float, sub: int):
    """Box with each face split into sub x sub cells, rotated about y."""
    c, s = np.cos(rot_y), np.sin(rot_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    h = 0.5 * np.asarray(size)
    parts = []
    for ax in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[ax] = sign
            u_ax, v_ax = [a for a in range(3) if a != ax]
            eu, ev = np.zeros(3), np.zeros(3)
            eu[u_ax], ev[v_ax] = 2 * h[u_ax], 2 * h[v_ax]
            if np.dot(np.cross(eu, ev), n) < 0:
                eu, ev = ev, eu
            origin = n * h - 0.5 * (eu + ev)
            parts.append(_patch(origin, eu, ev, sub, sub))
    return [(p @ rot.T + center, nn @ rot.T, uv, idx)
            for p, nn, uv, idx in parts]


def _sphere(center, radius: float, n_lat: int, n_lon: int):
    """UV sphere; the pole rows are single triangles (none degenerate)."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = _grid_indices(n_lat, n_lon).reshape(2, n_lat, n_lon, 3)
    # first triangle of each cell touches the next row; drop the one that
    # collapses at each pole
    tris = np.concatenate([idx[0, :-1].reshape(-1, 3),
                           idx[1, 1:].reshape(-1, 3)])[:, ::-1]
    return [(center + radius * n, n, uv, tris)]


def _cylinder(center, radius: float, height: float, n_seg: int,
              n_rings: int):
    """Capped cylinder standing on ``center`` (its base), axis +y."""
    ph = np.linspace(0, 2 * np.pi, n_seg + 1)
    y = np.linspace(0, height, n_rings + 1)
    ph_g, y_g = np.meshgrid(ph, y, indexing="ij")
    n = np.stack([np.cos(ph_g), np.zeros_like(ph_g), np.sin(ph_g)],
                 -1).reshape(-1, 3)
    pos = center + radius * n + np.stack(
        [np.zeros_like(y_g), y_g, np.zeros_like(y_g)], -1).reshape(-1, 3)
    uv = np.stack([ph_g / (2 * np.pi), y_g / height], -1).reshape(-1, 2)
    parts = [(pos, n, uv, _grid_indices(n_seg, n_rings)[:, ::-1])]
    for top in (0.0, 1.0):
        rim = np.stack([np.cos(ph[:-1]), np.zeros(n_seg),
                        np.sin(ph[:-1])], -1)
        cap = np.concatenate([np.zeros((1, 3)), radius * rim])
        cap = cap + center + np.array([0.0, top * height, 0.0])
        nn = np.broadcast_to([0.0, 1.0 if top else -1.0, 0.0], cap.shape)
        cuv = np.concatenate([[[0.5, 0.5]], 0.5 + 0.5 * rim[:, [0, 2]]])
        k = np.arange(n_seg)
        fan = np.stack([np.zeros(n_seg, int), 1 + k, 1 + (k + 1) % n_seg], 1)
        parts.append((cap, nn, cuv, fan[:, ::-1] if top else fan))
    return parts


def _texture(rng, kind: int) -> np.ndarray:
    """(TEX_SIZE, TEX_SIZE, 4) procedural texture in [0, 1]."""
    s = TEX_SIZE
    y, x = np.mgrid[0:s, 0:s] / s
    c0, c1 = rng.uniform(0.05, 0.95, (2, 3))
    freq = rng.integers(2, 9)
    if kind == 0:      # checker
        w = ((np.floor(x * freq) + np.floor(y * freq)) % 2)[..., None]
    elif kind == 1:    # stripes
        w = (0.5 + 0.5 * np.sin(2 * np.pi * freq * (x + 0.3 * y)))[..., None]
    elif kind == 2:    # smooth value noise (bilinear upsampling of a grid)
        g = rng.random((freq + 1, freq + 1))
        gx, gy = x * freq, y * freq
        ix, iy = gx.astype(int), gy.astype(int)
        fx, fy = gx - ix, gy - iy
        w = ((g[iy, ix] * (1 - fx) + g[iy, ix + 1] * fx) * (1 - fy)
             + (g[iy + 1, ix] * (1 - fx) + g[iy + 1, ix + 1] * fx) * fy
             )[..., None]
    else:              # rings
        r = np.hypot(x - 0.5, y - 0.5)
        w = (0.5 + 0.5 * np.cos(2 * np.pi * freq * r))[..., None]
    rgb = c0 * (1 - w) + c1 * w
    return np.concatenate([rgb, np.ones((s, s, 1))], -1).astype(np.float32)


def interior_materials(seed: int = 0):
    """(materials, textures): N_MATERIALS Disney materials, material i
    bound to procedural texture i in its diffuse slot."""
    rng = np.random.default_rng([seed, 1])
    mats, texs = [], []
    for i in range(N_MATERIALS):
        texs.append(Texture.from_array(_texture(rng, i % 4)))
        m = HostMaterial(
            name=f"interior_{i}",
            roughness=float(rng.uniform(0.05, 1.0)),
            metallic=float(rng.random() < 0.2))
        m.maps[0].texture_id = i
        mats.append(m)
    return mats, texs


def interior_mesh(seed: int = 0, material_base: int = 0) -> SceneMesh:
    """The room mesh (MESH_TRIANGLES triangles), material ids offset by
    ``material_base``."""
    rng = np.random.default_rng([seed, 0])
    rx, ry, rz = (float(v) for v in ROOM)
    fu, fv = FLOOR_CELLS
    x, y, z = np.eye(3)
    parts = [(_patch(np.zeros(3), rz * z, rx * x, fv, fu, (9, 6)), 0),
             (_patch(np.zeros(3), rx * x, ry * y, fu, 16, (6, 3)), 1),
             (_patch(np.zeros(3), ry * y, rz * z, 16, fv, (3, 9)), 2)]
    parts = [([p], m) for p, m in parts]

    def spot(margin):
        return np.array([rng.uniform(margin, rx - margin), 0.0,
                         rng.uniform(margin, rz - margin)])

    def material():
        return int(rng.integers(3, N_MATERIALS))

    for _ in range(N_BOXES):
        size = rng.uniform(0.3, 1.0, 3) * rng.choice([1.0, 2.5, 4.0])
        size[1] = min(size[1], ry)
        c = spot(1.0)
        c[1] = 0.5 * size[1] + (rng.random() < 0.2) * rng.uniform(0, 3)
        parts.append((_box(c, size, rng.uniform(0, np.pi), BOX_SUBDIV),
                      material()))
    for _ in range(N_SPHERES):
        r = rng.uniform(0.3, 2.0)
        c = spot(r + 0.5)
        c[1] = r + (rng.random() < 0.3) * rng.uniform(0, 3)
        parts.append((_sphere(c, r, SPHERE_LAT, SPHERE_LON), material()))
    for _ in range(N_CYLINDERS):
        r = rng.uniform(0.2, 1.0)
        h = rng.uniform(1.0, ry)
        parts.append((_cylinder(spot(r + 0.5), r, h, CYL_SEG, CYL_RINGS),
                      material()))

    pos, nrm, uv, idx, mat = [], [], [], [], []
    base = 0
    for pieces, m in parts:
        for p, n, t, tri in pieces:
            pos.append(p)
            nrm.append(n)
            uv.append(t)
            idx.append(tri + base)
            mat.append(np.full(len(tri), material_base + m, np.int32))
            base += len(p)
    return SceneMesh(positions=np.concatenate(pos).astype(np.float32),
                     indices=np.concatenate(idx).astype(np.int32),
                     normals=np.concatenate(nrm).astype(np.float32),
                     uv=np.concatenate(uv).astype(np.float32),
                     material_ids=np.concatenate(mat))


def build_interior(rs, seed: int = 0, grid: int = 2) -> dict:
    """Fill RenderSystem ``rs``: grid x grid instances of the room, the
    area light, the test sky and the camera. Returns the scene summary."""
    from .skybox import Skybox

    mats, texs = interior_materials(seed)
    tex_base = len(rs.materials.textures)
    mat_base = len(rs.materials)
    for m, t in zip(mats, texs):
        rs.materials.add_texture(t)
        m.maps[0].texture_id += tex_base
        rs.materials.add(m)
    room = rs.add_mesh(interior_mesh(seed, mat_base), name="interior")
    step = ROOM * 1.05
    for ix in range(grid):
        for iz in range(grid):
            rs.add_instance(room, translation=(ix * step[0], 0.0,
                                               iz * step[2]))
    extent = np.array([grid * step[0], ROOM[1], grid * step[2]])
    center = 0.5 * extent
    lamp = rs.add_material([40.0, 40.0, 40.0])
    rs.add_instance(rs.add_quad([0, -1, 0], center + [0, 18.0, 0], 6, 6,
                                lamp))
    rs.set_skybox(Skybox.test_sky())
    eye = center + np.array([0.3, 2.0, 0.45]) * extent
    rs.camera.look_at(eye, center)
    rs.camera.fov = 60.0
    return {"triangles": grid * grid * MESH_TRIANGLES + 2,
            "materials": len(mats), "textures": len(texs),
            "center": center, "eye": eye}
