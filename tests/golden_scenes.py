"""Scene builders for the BASELINE-config golden matrix.

Each builder mirrors one BASELINE.json config at golden-test scale
(64x64, low spp — pinning estimator behavior, not convergence):

* config 2 — full PT, NEE+MIS, area + point lights, diffuse + mirror
  (BASELINE.json configs[1]).
* config 3 — microfacet BSDF + textures + HDR-style envmap importance
  sampling (configs[2]; the test sky plays the HDR probe).

Regenerate goldens with: python tests/golden_scenes.py --regen
(only after an INTENDED estimator change; goldens are fp16 quantized).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from rfw_tpu.config import RenderConfig  # noqa: E402
from rfw_tpu.system import RenderSystem  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def make_config2(engine="megakernel", size=64, n_devices=0):
    """Cornell walls + mirror tall box + area lamp + point light."""
    cfg = RenderConfig(blue_noise=True, max_path_length=3,
                       n_devices=n_devices)
    rs = RenderSystem(engine, cfg)
    white = rs.add_material([0.73] * 3)
    red = rs.add_material([0.63, 0.065, 0.05])
    green = rs.add_material([0.14, 0.45, 0.091])
    mirror = rs.add_material([0.95, 0.95, 0.95], roughness=0.0,
                             metallic=1.0)
    lamp_m = rs.add_material([18.0] * 3)
    for (n, p, w, h, m) in [
        ([0, 1, 0], [0, 0, 0], 5.56, 5.56, white),
        ([0, -1, 0], [0, 5.48, 0], 5.56, 5.56, white),
        ([0, 0, -1], [0, 2.74, 2.796], 5.56, 5.48, white),
        ([1, 0, 0], [-2.78, 2.74, 0], 5.48, 5.56, red),
        ([-1, 0, 0], [2.78, 2.74, 0], 5.48, 5.56, green),
        ([0, -1, 0], [0, 5.47, 0], 1.3, 1.05, lamp_m),
        # mirror panel standing on the floor, angled toward the camera
        ([0.5, 0, -0.866], [-1.1, 1.1, 1.2], 1.8, 2.2, mirror),
    ]:
        g = rs.add_quad(n, p, w, h, m)
        rs.add_instance(g)
    rs.add_point_light([1.8, 4.5, -1.5], [12.0, 11.0, 10.0])
    rs.camera.resize(size, size)
    rs.camera.fov = 40.0
    rs.camera.look_at([0, 2.73, -8.0], [0, 2.73, 0])
    return rs


def make_config3(engine="megakernel", size=64, n_devices=0):
    """Microfacet BSDF + checker texture + envmap importance sampling."""
    from rfw_tpu.scene import Skybox, Texture

    cfg = RenderConfig(blue_noise=True, max_path_length=2, bsdf="microfacet",
                       envmap_nee=True, envmap_nee_max_depth=-1,
                       env_nee_interleave=0, n_devices=n_devices)
    rs = RenderSystem(engine, cfg)
    checker = np.indices((32, 32)).sum(0) % 2
    tex = Texture.from_array(np.stack(
        [checker * 0.7 + 0.15, checker * 0.5 + 0.2, 0.6 - checker * 0.3,
         np.ones((32, 32))], -1).astype(np.float32))
    tid = rs.materials.add_texture(tex)
    from rfw_tpu.scene import HostMaterial
    floor_mat = HostMaterial(name="floor", roughness=0.35, metallic=0.1)
    floor_mat.maps[0].texture_id = tid
    floor = rs.materials.add(floor_mat)
    shiny = rs.add_material([0.9, 0.7, 0.3], roughness=0.12, metallic=0.9)
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
    rs.add_instance(rs.add_quad([0, 0, -1], [0, 1.2, 2.0], 2.5, 2.4, shiny))
    rs.set_skybox(Skybox.test_sky(128, 64))
    rs.camera.resize(size, size)
    rs.camera.fov = 50.0
    rs.camera.look_at([0, 2.2, -5.5], [0, 1.0, 0.0])
    return rs


CESIUM = "/root/reference/assets/models/CesiumMan/CesiumMan.gltf"


def make_config4(engine="megakernel", size=64, n_devices=0):
    """Animated glTF skinning + BVH refit (BASELINE.json configs[3]).

    CesiumMan is posed mid-stride THROUGH the refit path: a full build at
    t=0, then ``set_animations_to(0.5)`` re-skins the vertices and the
    second synchronize refits (same topology). The golden therefore pins
    the skinning palette math AND the refit-rendered image in one frame
    (reference per-frame update, top_level_bvh.cpp:17-53)."""
    from rfw_tpu.scene import Skybox

    cfg = RenderConfig(blue_noise=True, max_path_length=2,
                       n_devices=n_devices)
    rs = RenderSystem(engine, cfg)
    ref = rs.add_object(CESIUM)
    rs.add_instance(ref)
    floor = rs.add_material([0.5, 0.5, 0.55])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
    rs.add_directional_light([0.4, -1.0, 0.3], [2.5, 2.4, 2.2])
    rs.set_skybox(Skybox.test_sky(128, 64))
    rs.set_animations_to(0.0)
    rs.camera.resize(size, size)
    rs.camera.fov = 45.0
    verts = np.concatenate([m.positions for m in ref.object.meshes])
    c = verts.mean(0)
    rs.camera.look_at(c + np.array([1.2, 0.6, 2.4]), c)
    rs.synchronize()                      # full build at the bind pose
    rs.set_animations_to(0.5)             # mid-stride -> refit path
    return rs


GOLDENS = {
    "config2_64_8spp": (make_config2, 8),
    "config3_64_8spp": (make_config3, 8),
    "config4_64_8spp": (make_config4, 8),
}


def render(name, engine="megakernel", n_devices=0):
    builder, spp = GOLDENS[name]
    rs = builder(engine=engine, n_devices=n_devices)
    return np.asarray(rs.render_frame(samples=spp))


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        print("pass --regen to overwrite goldens", file=sys.stderr)
        sys.exit(1)
    only = [a for a in sys.argv[1:] if not a.startswith("--")]
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in (only or GOLDENS):
        img = render(name)
        path = os.path.join(GOLDEN_DIR, f"{name}.npy")
        np.save(path, img.astype(np.float16))
        print(f"wrote {path}  mean={img.mean():.4f}")
