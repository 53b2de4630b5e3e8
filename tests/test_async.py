"""Host-async overlap (SURVEY §2 thread-pool analog; reference
system.cpp:438-458 overlaps animation updates with device work).

The async path must (a) return before blocking on the device where a
true async dispatch exists, and (b) produce bitwise-identical frames to
the synchronous path, including when host work (animation evaluation)
runs between dispatch and finish."""

import numpy as np

from rfw_tpu.config import RenderConfig
from rfw_tpu.render import RenderStatus
from rfw_tpu.system import RenderSystem


def _scene(engine="megakernel"):
    rs = RenderSystem(engine, RenderConfig(blue_noise=False))
    m = rs.add_material([0.7, 0.6, 0.5])
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 6, 6, m))
    lamp = rs.add_material([20.0, 20.0, 20.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 4.0, 0], 1, 1, lamp))
    rs.camera.resize(64, 64)
    rs.camera.look_at([0, 2.0, -5.0], [0, 0.5, 0])
    return rs


def test_async_matches_sync():
    rs = _scene()
    sync = rs.render_frame(status=RenderStatus.RESET, samples=2)

    rs2 = _scene()
    rs2.render_frame_async(status=RenderStatus.RESET, samples=2)
    a = rs2.finish_frame()
    assert np.array_equal(np.asarray(sync), np.asarray(a))


def test_async_overlap_with_host_work():
    """Animation evaluated for the NEXT frame between dispatch and finish
    must not disturb the in-flight frame (the overlap the reference's
    thread pool provides)."""
    rs = _scene()
    ref0 = rs.render_frame(status=RenderStatus.RESET, samples=1)

    rs2 = _scene()
    rs2.render_frame_async(status=RenderStatus.RESET, samples=1)
    # host-side scene mutation while the frame is in flight — applies to
    # the NEXT synchronize, not the dispatched one
    m2 = rs2.add_material([0.1, 0.9, 0.1])
    rs2.add_instance(rs2.add_quad([0, 0, -1], [0, 1.0, 2.0], 2, 2, m2))
    a = rs2.finish_frame()
    assert np.array_equal(np.asarray(ref0), np.asarray(a))
    # the mutation lands on the following frame
    b = rs2.render_frame(status=RenderStatus.RESET, samples=1)
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_async_abi_default_path():
    """Engines without a device-async override still honor the ABI."""
    rs = _scene("raster")
    rs.render_frame_async(status=RenderStatus.RESET, samples=1)
    a = rs.finish_frame()
    assert np.isfinite(np.asarray(a)).all()


def test_app_pipeline_matches_sequential(tmp_path):
    """App.run's pipelined loop (dispatch → update overlaps the render →
    finish) must produce frames bitwise-equal to the strictly sequential
    loop: scene/camera/tonemap inputs for frame k are snapshotted at
    dispatch, so update's mutations (camera orbit, brightness) only ever
    land on frame k+1 in both orders."""
    from rfw_tpu.app import App

    class Orbit(App):
        def __init__(self, tag):
            # each run gets its own camera file: App serializes the
            # end-state camera on exit (reference Camera.cpp:42-72), and a
            # shared file would leak run 1's orbit-mutated brightness into
            # run 2's initial tonemap.
            super().__init__(width=48, height=48, engine="megakernel",
                             config=RenderConfig(blue_noise=False),
                             camera_file=str(tmp_path / f"cam_{tag}.bin"),
                             fxaa=True)
            self.frames = []
            self.ticks = 0

        def init(self, rs):
            m = rs.add_material([0.7, 0.6, 0.5])
            rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 6, 6, m))
            lamp = rs.add_material([20.0, 20.0, 20.0])
            rs.add_instance(rs.add_quad([0, -1, 0], [0, 4.0, 0], 1, 1,
                                        lamp))
            rs.camera.look_at([0, 2.0, -5.0], [0, 0.5, 0])

        def update(self, rs, dt):
            self.ticks += 1
            ang = 0.4 * self.ticks
            rs.camera.look_at([5 * np.sin(ang), 2.0, -5 * np.cos(ang)],
                              [0, 0.5, 0])
            rs.camera.brightness = 0.05 * self.ticks
            return True

        def post_render(self, frame, frame_index):
            self.frames.append(np.asarray(frame))

    seq = Orbit("seq")
    seq.run(frames=3, samples_per_frame=2, pipeline=False)
    pipe = Orbit("pipe")
    pipe.run(frames=3, samples_per_frame=2, pipeline=True)
    assert seq.ticks == pipe.ticks == 3
    assert len(seq.frames) == len(pipe.frames) == 3
    for a, b in zip(seq.frames, pipe.frames):
        assert np.array_equal(a, b)
    # the camera genuinely moved between frames
    assert not np.array_equal(pipe.frames[0], pipe.frames[1])


def test_sample_batching_bitwise():
    """The single-chunk multi-sample fori_loop batch (one dispatch for N
    samples) must equal N separate single-sample dispatches bitwise —
    same trace_sample body per sample_index, same accumulation order."""
    rs = _scene()
    batched = rs.render_frame(status=RenderStatus.RESET, samples=3)

    rs2 = _scene()
    rs2.render_frame(status=RenderStatus.RESET, samples=1)
    rs2.render_frame(status=RenderStatus.CONVERGE, samples=1)
    looped = rs2.render_frame(status=RenderStatus.CONVERGE, samples=1)
    assert np.array_equal(np.asarray(batched), np.asarray(looped))


def test_double_dispatch_raises():
    """A second dispatch while a frame is in flight raises RuntimeError
    (not an assert, which ``python -O`` strips) and leaves the in-flight
    frame intact."""
    import pytest

    rs = _scene()
    rs.render_frame_async(status=RenderStatus.RESET, samples=1)
    with pytest.raises(RuntimeError, match="in flight"):
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=1)
    assert np.isfinite(rs.finish_frame()).all()
