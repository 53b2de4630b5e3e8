"""Merged material atlas (texture.py build_merged_material_atlas): one
trilinear fetch serves diffuse+normal+rough — must match the legacy
three-fetch path within RGBA8 quantization."""

import numpy as np

import rfw_tpu
from rfw_tpu.config import RenderConfig
from rfw_tpu.render import RenderStatus, create_engine
from rfw_tpu.scene import HostMaterial, MaterialList, Texture, make_quad
from rfw_tpu.scene.texture import (build_merged_material_atlas,
                                   build_texture_atlas)


def _material_list():
    ml = MaterialList()
    rng = np.random.default_rng(7)
    diff = rng.uniform(0.1, 1.0, (16, 16, 4)).astype(np.float32)
    diff[..., 3] = 1.0
    nrm = np.full((8, 8, 4), 0.5, np.float32)
    nrm[..., 2] = 0.9   # tilt all normals the same way
    nrm[2:6, 2:6, 0] = 0.8
    rough = np.ones((16, 16, 4), np.float32)
    rough[..., 1] = np.linspace(0.2, 1.0, 16, dtype=np.float32)[None, :]
    t_d = ml.add_texture(Texture.from_array(diff))
    t_n = ml.add_texture(Texture.from_array(nrm))
    t_r = ml.add_texture(Texture.from_array(rough))
    full = HostMaterial(name="full", roughness=0.8)
    full.maps[0].texture_id = t_d
    full.maps[1].texture_id = t_n
    full.maps[3].texture_id = t_r
    ml.add(full)
    ml.add(HostMaterial(color=np.array([4.0, 3.0, 2.0])))   # emissive, no tex
    diffuse_only = HostMaterial(name="d")
    diffuse_only.maps[0].texture_id = t_d
    ml.add(diffuse_only)
    return ml


def _render(ml, merged: bool, mpl: int = 0):
    # direct lighting by default: radiance is then CONTINUOUS in the texel
    # values, so the 8-bit merged quantization stays a small perturbation.
    # With bounces, a quantized roughness/normal shifts sampled directions
    # and single pixels flip between hitting the lamp or not (huge pixel
    # diffs at low spp that say nothing about correctness).
    # pin deterministic trilinear: this test compares the merged vs legacy
    # ATLAS (the default stochastic filter's tap noise would swamp the
    # 8-bit quantization bound, and the merged path is always trilinear)
    eng = create_engine("megakernel", RenderConfig(
        blue_noise=False, max_path_length=mpl, russian_roulette=False,
        texture_filter="trilinear"))
    floor = make_quad([0, 1, 0], [0, 0, 0], 4, 4, 0)
    wall = make_quad([0, 0, -1], [0, 1.0, 2.0], 4, 2, 2)
    lamp = make_quad([0, -1, 0], [0, 3.0, 0], 1, 1, 1)
    for slot, q in enumerate((floor, wall, lamp)):
        eng.set_mesh(slot, q.triangles())
        eng.set_instance(slot, slot, np.eye(4, dtype=np.float32))
    mats = ml.generate_device_materials()
    atlas = build_texture_atlas(ml.textures)
    if merged:
        matlas, mtex = build_merged_material_atlas(ml.materials, ml.textures)
        assert matlas is not None
        mats["mtex_id"] = mtex
        atlas.update(matlas)
    eng.set_materials(mats)
    eng.set_textures(atlas)
    from rfw_tpu.scene.lights import PointLight, pack_lights
    eng.set_lights(pack_lights(
        [], [PointLight(position=np.array([0.5, 2.5, -0.5], np.float32),
                        radiance=np.array([20.0, 20.0, 20.0], np.float32))],
        [], []))
    cam = rfw_tpu.Camera()
    cam.resize(48, 48)
    cam.fov = 55
    cam.look_at([0, 2.0, -3.5], [0, 0.5, 0.5])
    eng.resize(48, 48)
    return eng.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                            samples=8)


def test_merged_matches_legacy_within_quantization():
    ml = _material_list()
    a = _render(ml, merged=False)
    b = _render(ml, merged=True)
    # direct lighting: differences bounded by 8-bit texel quantization
    assert np.mean(np.abs(a - b)) < 0.005
    assert np.max(np.abs(a - b)) < 0.08
    assert a.mean() > 0.005         # scene actually lit


def test_merged_energy_with_bounces():
    ml = _material_list()
    a = _render(ml, merged=False, mpl=1)
    b = _render(ml, merged=True, mpl=1)
    # bounced paths diverge per pixel (see _render note); total energy and
    # image structure must still agree
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.1
    assert np.mean(np.abs(a - b)) < 0.05


def test_mtex_dedup_and_entries():
    ml = _material_list()
    matlas, mtex = build_merged_material_atlas(ml.materials, ml.textures)
    assert matlas is not None
    # entry 0 is the neutral entry; untextured material maps to it
    assert mtex[1] == 0
    # distinct triples → distinct entries
    assert mtex[0] != mtex[2] and mtex[0] != 0 and mtex[2] != 0
    desc = matlas["matlas_desc"]
    # merged resolution = max of bound maps (16x16 over the 8x8 normal map)
    assert tuple(desc[mtex[0], 0, 1:]) == (16, 16)


def test_uv_transform_with_normal_map_ineligible():
    ml = _material_list()
    ml.materials[0].maps[0].uv_scale = (2.0, 2.0)
    matlas, mtex = build_merged_material_atlas(ml.materials, ml.textures)
    assert matlas is None
    # diffuse-only material with a transform stays eligible
    ml2 = _material_list()
    ml2.materials[2].maps[0].uv_scale = (2.0, 2.0)
    matlas2, _ = build_merged_material_atlas(ml2.materials, ml2.textures)
    assert matlas2 is not None


def test_no_textures_no_matlas():
    ml = MaterialList()
    ml.add(HostMaterial())
    matlas, mtex = build_merged_material_atlas(ml.materials, ml.textures)
    assert matlas is None
    assert mtex.shape == (1,)


def test_texture_filter_modes_similar():
    """bilinear/nearest are speed knobs — images must stay close to
    trilinear on a direct-lit textured scene."""
    ml = _material_list()
    imgs = {}
    for mode in ("trilinear", "bilinear", "nearest", "stochastic"):
        from rfw_tpu.config import RenderConfig
        from rfw_tpu.render import RenderStatus, create_engine
        from rfw_tpu.scene.lights import PointLight, pack_lights
        from rfw_tpu.scene import make_quad
        import rfw_tpu
        eng = create_engine("megakernel", RenderConfig(
            blue_noise=False, max_path_length=0, russian_roulette=False,
            texture_filter=mode))
        floor = make_quad([0, 1, 0], [0, 0, 0], 4, 4, 0)
        eng.set_mesh(0, floor.triangles())
        eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
        mats = ml.generate_device_materials()
        eng.set_materials(mats)
        eng.set_textures(build_texture_atlas(ml.textures))
        eng.set_lights(pack_lights(
            [], [PointLight(position=np.array([0.5, 2.5, -0.5], np.float32),
                            radiance=np.array([20.0] * 3, np.float32))],
            [], []))
        cam = rfw_tpu.Camera()
        cam.resize(32, 32)
        cam.fov = 50
        cam.look_at([0, 2.0, -3.0], [0, 0.0, 0.0])
        eng.resize(32, 32)
        imgs[mode] = np.asarray(eng.render_frame(
            cam.get_view().as_pytree(), RenderStatus.RESET, samples=4))
    tri = imgs["trilinear"]
    assert tri.mean() > 1e-3
    for mode in ("bilinear", "nearest"):
        rel = np.abs(imgs[mode] - tri).mean() / tri.mean()
        assert rel < 0.15, (mode, rel)
    # stochastic (the default): per-pixel noise but the MEAN must match
    # trilinear tightly — its single tap is an unbiased estimator of the
    # 8-tap filter
    rel_mean = abs(imgs["stochastic"].mean() - tri.mean()) / tri.mean()
    assert rel_mean < 0.02, rel_mean
