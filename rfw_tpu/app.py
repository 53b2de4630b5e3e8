"""Application harness — the headless frame loop (L5).

Rebuild of ``rfw::app`` (/root/reference/RFW/system/src/rfw/app.{h,cpp}):
subclass, implement ``init``/``update``, call ``App.run``. The reference
drives a GLFW window + ImGui; a headless render service has no GL surface, so the
harness is headless: each frame is synchronized, rendered, tonemapped and
handed to ``post_render`` (write PNGs, stream, encode video). Camera state
persists to camera.bin across runs (app.cpp ctor/dtor behavior).
"""

from __future__ import annotations

import os

import numpy as np

from .camera import Camera
from .config import RenderConfig
from .system import RenderSystem
from .utils import Timer, image, logger


class App:
    """Subclass and override init/update/post_render (app.h:23-61)."""

    def __init__(self, width: int = 512, height: int = 512,
                 engine: str = "megakernel",
                 config: RenderConfig | None = None,
                 camera_file: str = "camera.bin",
                 output_dir: str = "frames",
                 fxaa: bool = True):
        self.rs = RenderSystem(engine, config)
        self.camera_file = camera_file
        self.output_dir = output_dir
        # the reference app FXAAs the tonemapped target before the blit
        # (app.h:23-61); ops/tonemap.fxaa is the jnp analog
        self.fxaa = fxaa
        self.rs.camera = Camera.deserialize(camera_file)
        self.rs.camera.resize(width, height)
        self.frame_index = 0

    # -- user hooks (app.h) --------------------------------------------------

    def init(self, rs: RenderSystem) -> None:
        """Build the scene: add_object / add_quad / lights / materials."""

    def update(self, rs: RenderSystem, dt: float) -> bool:
        """Advance state (camera moves, set_animations_to). Return False to
        stop the loop."""
        return False

    def post_render(self, frame: np.ndarray, frame_index: int) -> None:
        """Receive the tonemapped frame (H, W, 3) linear [0,1]."""
        os.makedirs(self.output_dir, exist_ok=True)
        image.save_png(
            os.path.join(self.output_dir, f"frame_{frame_index:05d}.png"),
            frame)

    # -- loop (app.cpp:3-26) -------------------------------------------------

    def run(self, frames: int = 1, samples_per_frame: int = 1,
            pipeline: bool = True) -> None:
        """Frame loop (app.cpp:3-26). With ``pipeline=True`` (default)
        each frame is DISPATCHED asynchronously and ``update`` — host
        animation sampling, skinning einsums, camera moves — runs while
        the chip traces it (the reference overlaps these with a thread
        pool, system.cpp:438-458; XLA async dispatch provides the same
        overlap thread-free). Frames are identical either way: the
        scene/camera for frame k are snapshotted at dispatch, so
        ``update``'s mutations only ever affect frame k+1, exactly as in
        the sequential loop (tests/test_async.py::
        test_app_pipeline_matches_sequential).

        Hook-ordering caveat: the FRAMES are identical, but with
        ``pipeline=True`` the ``update`` for frame k+1 runs BEFORE frame
        k's ``post_render`` and before ``frame_index`` increments (it
        overlaps the render). Subclasses whose ``update`` reads
        ``self.frame_index`` or state written by ``post_render`` should
        pass ``pipeline=False``."""
        self.init(self.rs)
        timer = Timer()
        for _ in range(frames):
            dt = timer.elapsed()
            timer.reset()
            if pipeline:
                cam = self.rs.camera
                brightness, contrast = cam.brightness, cam.contrast
                self.rs.render_frame_async(samples=samples_per_frame)
                try:
                    running = self.update(self.rs, dt)  # overlaps render
                finally:
                    # always retire the in-flight frame: a raising
                    # update() must not leave the engine's _pending set
                    # (a later dispatch would trip its in-flight guard)
                    frame = self.rs.tonemap_frame(self.rs.finish_frame(),
                                                  brightness, contrast,
                                                  fxaa=self.fxaa)
            else:
                frame = self.rs.render_tonemapped(
                    samples=samples_per_frame, fxaa=self.fxaa)
            self.post_render(frame, self.frame_index)
            self.frame_index += 1
            stats = self.rs.get_render_stats()
            logger.debug(
                "frame %d: %.1f ms render, %.2f Mrays/s", self.frame_index,
                stats.render_time * 1e3, stats.mrays_per_s())
            if not (running if pipeline else self.update(self.rs, dt)):
                break
        try:
            self.rs.camera.serialize(self.camera_file)
        except OSError as e:
            logger.warning("could not persist camera: %s", e)
