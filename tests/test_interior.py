"""The seeded interior (rfw_tpu/scene/interior.py): the benchmark's and
the smoke run's scene, built in memory from a seed."""

import numpy as np
import pytest

from rfw_tpu.scene import interior
from rfw_tpu.system import RenderSystem


@pytest.fixture(scope="module")
def system():
    rs = RenderSystem("megakernel")
    info = interior.build_interior(rs, seed=0)
    return rs, info


def test_triangle_count(system):
    rs, info = system
    mesh = interior.interior_mesh(0)
    assert mesh.triangle_count == interior.MESH_TRIANGLES
    assert 74_000 <= interior.MESH_TRIANGLES <= 78_000
    # 2 x 2 instances of the room plus the two-triangle area light
    per_instance = [inst.geometry.object.meshes[0].triangle_count
                    for inst in rs._instances]
    assert sorted(per_instance) == [2] + [interior.MESH_TRIANGLES] * 4
    assert info["triangles"] == sum(per_instance) == 303_874


def test_materials_and_textures(system):
    rs, info = system
    assert info["materials"] == info["textures"] == interior.N_MATERIALS
    assert len(rs.materials.textures) == interior.N_MATERIALS
    mats = rs.materials.materials
    assert len(mats) == interior.N_MATERIALS + 1          # + the lamp
    tex_ids = [m.maps[0].texture_id for m in mats[:interior.N_MATERIALS]]
    assert sorted(tex_ids) == list(range(interior.N_MATERIALS))
    assert mats[-1].is_emissive()
    used = np.unique(rs._instances[0].geometry.object.meshes[0].material_ids)
    assert used.min() >= 0 and used.max() < interior.N_MATERIALS
    assert len(used) > interior.N_MATERIALS // 2


def test_same_seed_same_scene():
    a, b = interior.interior_mesh(3), interior.interior_mesh(3)
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.material_ids, b.material_ids)
    (ma, ta), (mb, tb) = (interior.interior_materials(3),
                          interior.interior_materials(3))
    assert all(np.array_equal(x.mips[0], y.mips[0]) for x, y in zip(ta, tb))
    assert [m.roughness for m in ma] == [m.roughness for m in mb]


def test_different_seeds_differ():
    a, b = interior.interior_mesh(0), interior.interior_mesh(1)
    assert a.triangle_count == b.triangle_count
    assert a.positions.shape == b.positions.shape
    assert not np.allclose(a.positions, b.positions)
    tris = a.triangles()
    assert np.isfinite(tris.vertices).all()
    assert (tris.area > 0).all()             # no degenerate triangles
