"""Benchmark: ray throughput of the flagship engine on one NVIDIA GPU.

Prints ONE JSON line: metric, value, unit, the device it ran on and the
windows behind the median. The scene is the seeded textured interior
(``rfw_tpu/scene/interior.py``): 2 x 2 instances of a ~76k-triangle room,
303,874 triangles, 36 textured materials, an area light and the test sky,
rendered at 1920x1080 with the default ``RenderConfig``. Fails when JAX
finds no GPU.

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _cache_state() -> dict:
    """State of the compile cache in use and of the scene cache BEFORE the
    run, so run-to-run differences are attributable in the artifact: a
    cold compile cache re-pays XLA compiles; a cold scene cache re-pays
    the geometry build."""
    from rfw_tpu._jax_setup import cache_dir
    from rfw_tpu.render.scene_data import _scene_cache_dir

    def entries(d):
        try:
            return sum(len(fs) for _, _, fs in os.walk(d)) if d else 0
        except OSError:
            return 0

    jc, sc = cache_dir(), _scene_cache_dir()
    n_jax = entries(jc)
    return {"jax_cache_dir": jc,
            "jax_cache": "warm" if n_jax > 0 else "cold",
            "jax_cache_entries": n_jax,
            "scene_cache": "warm" if entries(sc) > 0 else "cold"}


def _device() -> dict:
    """The device this run measures; exits when it is not a GPU."""
    import jax

    from chip_smoke import card_label

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {devs[0].platform!r})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_label()}


def main() -> None:
    cache_state = _cache_state()
    t_setup = time.time()
    device = _device()
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus
    from rfw_tpu.scene.interior import build_interior
    from rfw_tpu.system import RenderSystem

    engine = os.environ.get("RFW_BENCH_ENGINE", "wavefront")
    width, height = 1920, 1080
    # per-stage times are diagnostic-only and cost a SECOND compiled
    # program set — opt in with RFW_BENCH_PROFILE=1
    config = RenderConfig(
        profile_stages=bool(os.environ.get("RFW_BENCH_PROFILE")))
    rs = RenderSystem(engine, config)
    t_scene0 = time.time()
    info = build_interior(rs, seed=0)
    rs.camera.resize(width, height)
    rs.synchronize()
    t_scene = time.time() - t_scene0

    # warmup: compile + first samples (samples=2 so the profiled step —
    # when enabled — also compiles here rather than in the timed run)
    rs.render_frame(samples=2)
    setup_s = time.time() - t_setup
    print(f"# setup+compile {setup_s:.1f}s (scene load+build+upload "
          f"{t_scene:.1f}s)", file=sys.stderr)

    # timed region: ≥2 independent CONVERGE windows; the headline is the
    # MEDIAN window
    samples = int(os.environ.get("RFW_BENCH_SAMPLES", "4"))
    n_windows = max(2, int(os.environ.get("RFW_BENCH_WINDOWS", "3")))
    window_ms = []
    t_dispatch = 0.0
    for _ in range(n_windows):
        t0 = time.time()
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=samples)
        t_dispatch = time.time() - t0
        rs.finish_frame()
        window_ms.append((time.time() - t0) * 1000.0)
    window_ms_sample = sorted(w / samples for w in window_ms)
    med = window_ms_sample[len(window_ms_sample) // 2] \
        if n_windows % 2 else 0.5 * (window_ms_sample[n_windows // 2 - 1]
                                     + window_ms_sample[n_windows // 2])
    spread = window_ms_sample[-1] - window_ms_sample[0]
    elapsed = med * samples / 1000.0
    print(f"# dispatch {t_dispatch*1000:.0f} ms, per-sample windows "
          f"{[round(w) for w in window_ms_sample]} ms (median {med:.0f}, "
          f"spread {spread:.0f})", file=sys.stderr)

    stats = rs.get_render_stats()
    rays_per_sample = (stats.primary_count + stats.secondary_count
                       + stats.deep_count + stats.shadow_count)
    total_rays = rays_per_sample * samples
    mrays = total_rays / elapsed / 1e6
    print(f"# {med:.0f} ms/sample | rays/sample: "
          f"primary {stats.primary_count/1e6:.2f}M secondary "
          f"{stats.secondary_count/1e6:.2f}M deep {stats.deep_count/1e6:.2f}M "
          f"shadow {stats.shadow_count/1e6:.2f}M", file=sys.stderr)

    # warm-session TTFP: a SECOND RenderSystem in the same process —
    # what a new scene/session costs once the process + program caches
    # are hot (scene build + synchronize + first 1-spp frame; the
    # compiled 1080p programs are reused, so this isolates the
    # non-compile part of time-to-first-pixel)
    t_warm = time.time()
    rs2 = RenderSystem(engine, config)
    build_interior(rs2, seed=0)
    rs2.camera.resize(width, height)
    rs2.synchronize()
    rs2.render_frame(samples=1)
    warm_s = time.time() - t_warm
    print(f"# warm-session TTFP {warm_s:.1f}s", file=sys.stderr)

    # per-stage split (context.h:50-72 parity — measured by the profiled
    # step's inter-depth syncs; imgui_app/main.cpp:270-296 displays the
    # same). The profiled step is a SECOND compiled program set, so it
    # runs AFTER the timed window; RFW_BENCH_SPLIT=0 skips it.
    stage_ms = None
    if (os.environ.get("RFW_BENCH_SPLIT", "1") != "0"
            and getattr(rs.context, "_driver", None) is not None):
        if not config.profile_stages:
            object.__setattr__(rs.context.config, "profile_stages", True)
            # the first profiled frame compiles the per-depth stage
            # programs inside the timed depth windows — warm it first
            rs.render_frame(status=RenderStatus.CONVERGE, samples=2)
        rs.render_frame(status=RenderStatus.CONVERGE, samples=2)
        stats = rs.get_render_stats()
        stage_ms = {"primary": round(stats.primary_time * 1000),
                    "secondary": round(stats.secondary_time * 1000),
                    "deep": round(stats.deep_time * 1000)}
        print(f"# stage ms: {stage_ms}", file=sys.stderr)

    out = {
        "metric": f"Mrays/s (seeded interior, {info['triangles']} tris, "
                  f"1080p path trace, {engine})",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": device,
        "ms_per_sample_median": round(med, 1),
        "ms_per_sample_windows": [round(w, 1) for w in window_ms_sample],
        "rays_per_sample": {
            "primary": int(stats.primary_count),
            "secondary": int(stats.secondary_count),
            "deep": int(stats.deep_count),
            "shadow": int(stats.shadow_count),
            "total": int(rays_per_sample)},
        "cache_state": cache_state,
        "setup_compile_s": round(setup_s, 1),
        "scene_build_s": round(t_scene, 1),
        "warm_session_ttfp_s": round(warm_s, 1),
    }
    if stage_ms is not None:
        out["stage_ms"] = stage_ms
    print(json.dumps(out))


if __name__ == "__main__":
    main()
