"""Cornell box — BASELINE config 1/2 scene, built procedurally with quads.

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH=/root/repo python examples/cornell.py \
      --out cornell.png --size 256 --spp 16 --engine megakernel
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# --cpu must take effect BEFORE any rfw_tpu/jax.numpy import: module
# constants would otherwise initialize the default (GPU) backend
if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import rfw_tpu  # noqa: E402
from rfw_tpu.scene import HostMaterial, MaterialList, make_quad  # noqa: E402
from rfw_tpu.scene.lights import AreaLight, pack_lights  # noqa: E402
from rfw_tpu.render import RenderStatus, create_engine  # noqa: E402
from rfw_tpu.ops import tonemap  # noqa: E402
from rfw_tpu.utils import image  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def build_cornell(engine, light_radiance=(30.0, 30.0, 30.0)):
    """Classic box: white floor/ceiling/back, red left, green right wall,
    emissive quad under the ceiling, two boxes' stand-ins (a tall and a
    short quad-box would need 12 quads; keep two cubes simple)."""
    ml = MaterialList()
    white = ml.add(HostMaterial(name="white", roughness=1.0,
                                color=np.array([0.73, 0.73, 0.73])))
    red = ml.add(HostMaterial(name="red", roughness=1.0,
                              color=np.array([0.63, 0.065, 0.05])))
    green = ml.add(HostMaterial(name="green", roughness=1.0,
                                color=np.array([0.14, 0.45, 0.091])))
    light = ml.add(HostMaterial(name="light",
                                color=np.asarray(light_radiance)))

    quads = [
        make_quad([0, 1, 0], [0, 0, 0], 5.56, 5.56, white),      # floor
        make_quad([0, -1, 0], [0, 5.48, 0], 5.56, 5.56, white),  # ceiling
        make_quad([0, 0, -1], [0, 2.74, 2.796], 5.56, 5.48, white),  # back
        make_quad([1, 0, 0], [-2.78, 2.74, 0], 5.48, 5.56, red),     # left
        make_quad([-1, 0, 0], [2.78, 2.74, 0], 5.48, 5.56, green),   # right
        make_quad([0, -1, 0], [0, 5.47, 0], 1.3, 1.05, light),       # lamp
    ]

    area_lights = []
    overrides = {}
    for slot, q in enumerate(quads):
        engine.set_mesh(slot, q.triangles())
        engine.set_instance(slot, slot, np.eye(4, dtype=np.float32))
    # extract the lamp's two triangles as area lights (what
    # system.update_area_lights does; here inline for the example)
    lamp_tris = quads[-1].triangles()
    lamp_slot = len(quads) - 1
    for i in range(lamp_tris.count):
        v = lamp_tris.vertices[i]
        area_lights.append(AreaLight(
            vertex0=v[0], vertex1=v[1], vertex2=v[2],
            normal=lamp_tris.gnormal[i],
            radiance=np.asarray(light_radiance, np.float32),
            area=float(lamp_tris.area[i]), tri_idx=i, inst_idx=lamp_slot))
        overrides[(lamp_slot, i)] = i

    engine.set_materials(ml.generate_device_materials())
    engine.set_lights(pack_lights(area_lights, [], [], []),
                      overrides=overrides)
    return ml


def default_camera(size):
    cam = rfw_tpu.Camera()
    cam.resize(size, size)
    cam.fov = 40.0
    cam.look_at([0.0, 2.73, -8.0], [0.0, 2.73, 0.0])
    return cam


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="cornell.png")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--engine", default="megakernel")
    ap.add_argument("--cpu", action="store_true",
                    help="force the local CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    engine = create_engine(args.engine)
    build_cornell(engine)
    cam = default_camera(args.size)
    engine.resize(args.size, args.size)
    view = cam.get_view().as_pytree()
    hdr = engine.render_frame(view, RenderStatus.RESET, samples=args.spp)
    stats = engine.get_stats()
    print(f"rendered {args.size}x{args.size}@{args.spp}spp in "
          f"{stats.render_time:.2f}s — {stats.mrays_per_s():.2f} Mrays/s "
          f"(engine={args.engine})")
    ldr = np.asarray(tonemap.tonemap(jnp.asarray(hdr), cam.brightness,
                                     cam.contrast))
    image.save_png(args.out, ldr)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
