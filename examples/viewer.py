"""Interactive live viewer demo: drive the camera around a scene in the
browser (the reference imgui_app analog).

    JAX_PLATFORMS=cpu python examples/viewer.py --size 256 --port 8000
    # open http://127.0.0.1:8000 — WASD/QE + arrows, click to probe

On a GPU machine run without JAX_PLATFORMS to render on the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from rfw_tpu.config import RenderConfig  # noqa: E402
from rfw_tpu.system import RenderSystem  # noqa: E402
from rfw_tpu.viewer import LiveViewer  # noqa: E402


def build(rs: RenderSystem, asset: str | None):
    if asset and os.path.exists(asset):
        ref = rs.add_object(asset)
        rs.add_instance(ref)
        v = np.concatenate([m.triangles().vertices.reshape(-1, 3)
                            for m in ref.object.meshes])
        lo, hi = v.min(0), v.max(0)
        c = 0.5 * (lo + hi)
        rs.camera.look_at(c + (hi - lo) * np.array([0.8, 0.5, 1.2]), c)
    else:
        floor = rs.add_material([0.6, 0.6, 0.65])
        red = rs.add_material([0.7, 0.15, 0.1])
        rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
        rs.add_instance(rs.add_quad([0, 0, -1], [0, 1, 2], 2, 2, red))
        rs.camera.look_at([0, 2.5, -5.0], [0, 1.0, 0.0])
    lamp = rs.add_material([30.0, 30.0, 30.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 6.0, 0], 2, 2, lamp))
    from rfw_tpu.scene import Skybox
    rs.set_skybox(Skybox.test_sky(128, 64))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--engine", default="wavefront")
    ap.add_argument("--asset", default=None,
                    help="model path (gltf/obj/...); default quad scene")
    ap.add_argument("--duration", type=float, default=None)
    args = ap.parse_args()

    rs = RenderSystem(args.engine, RenderConfig())
    build(rs, args.asset)
    viewer = LiveViewer(rs, args.size, args.size, port=args.port)
    viewer.run(duration=args.duration)


if __name__ == "__main__":
    main()
