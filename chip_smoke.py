#!/usr/bin/env python3
"""Smoke run of the wavefront path tracer on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the tiled frame only

One process drives the card. Phases, in order (any failure exits non-zero
and prints no result line):

1. device  — requires ``jax.devices()[0].platform == "gpu"`` and prints
   the card's name and power limit (``nvidia-smi``) beside every number;
2. kernels — the visit kernel (Pallas through Triton), compiled at the
   smoke scene's widths, against the plain ``bvh`` traversal on the same
   rays: 2,073,600 primary rays and one scattered depth-1 bounce batch;
3. main path — ``RenderSystem("wavefront")`` renders the seeded ~305k-
   triangle interior at 1920x1080: CONVERGE samples through
   ``render_frame_async``/``finish_frame`` and 1-spp RESET frames;
4. oracle — the in-repo 64x64 goldens rendered with ``wavefront`` against
   their stored CPU images, and the 1080p 1-spp ``wavefront`` frame
   against the ``megakernel`` (plain ``bvh``) frame.

The last line of standard output is one JSON object naming the device.
Times printed here are a record of this run, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
MIN_BOUNCE_RAYS = 512 * 1024

# Bounds, and why. Every random draw is keyed by pixel (and sample and
# depth), so two renders of one scene differ only where float order, or
# a different triangle test, changes a hit: never through sampling.
# - Closest hit / occlusion: visit (Woop FMA test + Möller–Trumbore
#   refinement) and bvh (Möller–Trumbore) disagree only for rays that
#   graze a shared edge within float rounding, or tie at equal t.
HIT_MISMATCH_FRAC = 1e-4       # hit/miss or occluded/visible disagreements
T_REL = 1e-4                   # |dt| <= T_REL * t where both hit one prim
# - A 64x64 golden: one sample-path that takes another branch moves its
#   pixel by ~radiance/spp; 1e-2 RMSE admits ~25 such paths of 4096 px.
GOLDEN_RMSE = 1e-2
# - 1080p 1 spp, wavefront (visit) vs megakernel (bvh): each disagreeing
#   hit changes one path by up to the firefly clamp; at the hit-mismatch
#   bound plus float-order drift that stays well under 5e-2 RMSE, and
#   fewer than 1% of pixels move by more than 1e-2 (float-order drift
#   alone stays below that).
FRAME_RMSE, FRAME_MOVED_FRAC = 5e-2, 1e-2
# - Tiled (4 cards) vs one card, both wavefront: the same estimator; only
#   the per-card block formation (ties at equal t) differs.
TILED_RMSE = 5e-3


def parse_gpu_query(text: str) -> list[tuple[str, str]]:
    """Rows of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` → [(name, power_limit)]."""
    rows = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, sep, power = line.rpartition(",")
        if not sep or not name.strip() or not power.strip():
            raise ValueError(f"unexpected nvidia-smi row: {line!r}")
        rows.append((name.strip(), power.strip()))
    if not rows:
        raise ValueError("nvidia-smi listed no GPU")
    return rows


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, power = parse_gpu_query(out)[0]
    return f"{name}, {power}"


_T0 = time.time()


def log(card: str, msg: str) -> None:
    print(f"[{card}] +{time.time() - _T0:.0f}s {msg}", flush=True)


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); nothing was run")
    card = card_label()
    print(f"card: {card}", flush=True)
    log(card, f"jax {jax.__version__}, device_kind {devs[0].device_kind}, "
              f"{len(devs)} device(s)")
    return devs, card


def build(engine: str, seed: int, config=None):
    from rfw_tpu.scene.interior import build_interior
    from rfw_tpu.system import RenderSystem

    rs = RenderSystem(engine, config)
    info = build_interior(rs, seed)
    rs.camera.resize(WIDTH, HEIGHT)
    return rs, info


def primary_rays(rs):
    """Pixel-centre pinhole rays of the camera, row-major (N, 3) each."""
    v = rs.camera.get_view()
    w, h = rs.camera.pixel_count
    x = (np.arange(w, dtype=np.float32) + 0.5) / w
    y = (np.arange(h, dtype=np.float32) + 0.5) / h
    p = (v.p1[None, None] + x[None, :, None] * (v.p2 - v.p1)
         + y[:, None, None] * (v.p3 - v.p1)).reshape(-1, 3)
    d = p - v.pos
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(v.pos, d.shape).astype(np.float32)
    return o, d.astype(np.float32)


def compare_closest(name, ref, got, card):
    """Hit/miss agreement, t agreement on equal prims, prim ties."""
    t_r, p_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_g, p_g = np.asarray(got[0]), np.asarray(got[1])
    n = t_r.shape[0]
    hit_r, hit_g = p_r >= 0, p_g >= 0
    n_hitmiss = int((hit_r != hit_g).sum())
    both = hit_r & hit_g
    rel = np.abs(t_g - t_r) / np.maximum(t_r, 1e-6)
    same = both & (p_r == p_g)
    n_t = int((rel[same] > T_REL).sum())
    diff = both & (p_r != p_g)
    n_tie = int((diff & (rel <= T_REL)).sum())
    n_prim = int((diff & (rel > T_REL)).sum())
    log(card, f"{name}: {n} rays, {int(hit_r.sum())} hits; hit/miss "
              f"mismatches {n_hitmiss}, prim mismatches {n_prim} (+{n_tie} "
              f"ties at equal t), |dt| > {T_REL}*t on equal prims {n_t} "
              f"(bounds: {HIT_MISMATCH_FRAC:g}*N mismatches, 0 t errors)")
    return max(n_hitmiss, n_prim) > HIT_MISMATCH_FRAC * n or n_t > 0


def compare_occluded(name, ref, got, card):
    r, g = np.asarray(ref), np.asarray(got)
    n_bad = int((r != g).sum())
    log(card, f"{name}: {r.shape[0]} rays, {int(r.sum())} occluded; "
              f"mismatches {n_bad} (bound {HIT_MISMATCH_FRAC:g}*N)")
    return n_bad > HIT_MISMATCH_FRAC * r.shape[0]


def phase_kernels(rs, card, seed: int) -> list[str]:
    """Each kept kernel against the plain bvh reference at real widths."""
    import jax
    import jax.numpy as jnp

    from rfw_tpu.render.intersectors import FACTORIES

    scene, cfg = rs.context._scene, rs.context.config
    bvh, visit = FACTORIES["bvh"](cfg), FACTORIES["visit"](cfg)
    failures = []

    def run(label, fn, *args):
        t0 = time.time()
        compiled = jax.jit(fn).lower(scene, *args).compile()
        log(card, f"{label}: compiled in {time.time() - t0:.1f} s; "
                  f"memory_analysis {compiled.memory_analysis()}")
        out = compiled(scene, *args)
        jax.block_until_ready(out)
        t0 = time.time()
        out = compiled(scene, *args)
        jax.block_until_ready(out)
        log(card, f"{label}: {1e3 * (time.time() - t0):.1f} ms")
        return out

    o_np, d_np = primary_rays(rs)
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    # primary stream, launched like the integrator's depth 0
    ref = run("bvh closest, primary", lambda s, o, d: bvh.closest(s, o, d),
              o, d)
    got = run("visit closest, primary",
              lambda s, o, d: visit.closest(s, o, d, sort=False,
                                            coherent=True), o, d)
    if compare_closest("closest, primary", ref, got, card):
        failures.append("visit closest (primary) disagrees with bvh")

    # one scattered depth-1 batch: cosine-weighted bounces off the
    # primary hits, then shadow rays from those hits to the area light
    rng = np.random.default_rng(seed)
    bo, bd = bounce_rays(scene, o_np, d_np, np.asarray(ref[0]),
                         np.asarray(ref[1]), rng)
    if bo.shape[0] < MIN_BOUNCE_RAYS:
        failures.append(f"bounce batch has only {bo.shape[0]} rays")
    bo_j, bd_j = jnp.asarray(bo), jnp.asarray(bd)
    ref_b = run("bvh closest, bounce",
                lambda s, o, d: bvh.closest(s, o, d), bo_j, bd_j)
    got_b = run("visit closest, bounce",
                lambda s, o, d: visit.closest(s, o, d), bo_j, bd_j)
    if compare_closest("closest, bounce", ref_b, got_b, card):
        failures.append("visit closest (bounce) disagrees with bvh")

    target = _light_points(scene, rng, bo.shape[0])
    sd = target - bo
    dist = np.linalg.norm(sd, axis=1)
    sd = (sd / dist[:, None]).astype(np.float32)
    dist = (dist * (1 - 1e-4)).astype(np.float32)
    args = (bo_j, jnp.asarray(sd), jnp.asarray(dist))
    ref_o = run("bvh occluded, shadow",
                lambda s, o, d, m: bvh.occluded(s, o, d, m), *args)
    got_o = run("visit occluded, shadow",
                lambda s, o, d, m: visit.occluded(s, o, d, m), *args)
    if compare_occluded("occluded, shadow", ref_o, got_o, card):
        failures.append("visit any-hit disagrees with bvh")
    return failures


def bounce_rays(scene, o, d, t, prim, rng):
    """Cosine-weighted depth-1 bounce rays off the hits (prim >= 0) of
    primary rays (o, d) with closest-hit (t, prim)."""
    hit = prim >= 0
    p = (o + t[:, None] * d)[hit]
    n = np.asarray(scene["tri_gnormal"])[prim[hit]]
    n = np.where((n * d[hit]).sum(1, keepdims=True) > 0, -n, n)
    u1, u2 = rng.random((2, p.shape[0]))
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0, 0]])
    tx = np.cross(n, a)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(n, tx)
    r, ph = np.sqrt(u1)[:, None], 2 * np.pi * u2[:, None]
    bd = (r * np.cos(ph) * tx + r * np.sin(ph) * ty
          + np.sqrt(1 - u1)[:, None] * n).astype(np.float32)
    return (p + 1e-3 * n).astype(np.float32), bd


def _light_points(scene, rng, n):
    """n uniform points on the scene's first area light triangle pair."""
    lt = scene["lights"]
    v0 = np.asarray(lt["area_v0"])[:2]
    v1 = np.asarray(lt["area_v1"])[:2]
    v2 = np.asarray(lt["area_v2"])[:2]
    k = rng.integers(0, v0.shape[0], n)
    u, v = rng.random((2, n))
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    return (v0[k] + u[:, None] * (v1[k] - v0[k])
            + v[:, None] * (v2[k] - v0[k])).astype(np.float32)


def setup_scene(seed: int, card: str):
    """``RenderSystem("wavefront")`` on the seeded interior, synchronized;
    fails if the system fell back to another engine or intersector."""
    from rfw_tpu.render.engines import GPU_INTERSECTOR, WavefrontEngine

    t0 = time.time()
    rs, info = build("wavefront", seed)
    eng = rs.context
    if type(eng) is not WavefrontEngine:
        raise RuntimeError(f"RenderSystem fell back to {type(eng).__name__}")
    if eng._intersector_name != GPU_INTERSECTOR:
        raise RuntimeError(f"wavefront engine chose {eng._intersector_name}"
                           f", not the GPU default {GPU_INTERSECTOR}")
    rs.synchronize()
    log(card, f"scene: {info['triangles']} triangles, {info['materials']} "
              f"materials, {info['textures']} textures; build+upload "
              f"{time.time() - t0:.1f} s")
    return rs, t0


def phase_main_path(rs, t0: float, card: str):
    """Render the seeded interior through the user-facing entry points."""
    from rfw_tpu.render import RenderStatus

    failures = []
    t1 = time.time()
    rs.render_frame_async(samples=2)
    rs.finish_frame()
    log(card, f"warm-up (compile + 2 samples) {time.time() - t1:.1f} s; "
              f"set-up to first frame {time.time() - t0:.1f} s")

    spp = 4
    t1 = time.time()
    rs.render_frame_async(status=RenderStatus.CONVERGE, samples=spp)
    frame = rs.finish_frame()
    ms = 1e3 * (time.time() - t1) / spp
    st = rs.get_render_stats()
    rays = (st.primary_count + st.secondary_count + st.deep_count
            + st.shadow_count)
    log(card, f"CONVERGE {spp} spp: {ms:.1f} ms/sample, {rays} rays/sample "
              f"(primary {st.primary_count}, secondary "
              f"{st.secondary_count}, deep {st.deep_count}, shadow "
              f"{st.shadow_count}), {rays / ms / 1e3:.1f} Mrays/s")
    if st.primary_count != WIDTH * HEIGHT:
        failures.append(f"primary rays/sample {st.primary_count} != "
                        f"{WIDTH * HEIGHT}")
    if frame.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(frame).all() \
            or not frame.mean() > 0:
        failures.append(f"CONVERGE frame {frame.shape}, finite "
                        f"{np.isfinite(frame).all()}, mean {frame.mean()}")
    times = []
    for _ in range(3):
        t1 = time.time()
        rs.render_frame_async(status=RenderStatus.RESET, samples=1)
        reset = rs.finish_frame()
        times.append(1e3 * (time.time() - t1))
    log(card, f"RESET 1-spp frames: {', '.join(f'{t:.1f}' for t in times)}"
              f" ms")
    if not np.isfinite(reset).all() or not reset.mean() > 0:
        failures.append("RESET frame not finite or black")
    return reset, failures


def phase_oracle(seed: int, card: str, wave_frame) -> list[str]:
    """64x64 goldens, and the 1080p frame against the megakernel engine."""
    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from golden_scenes import GOLDEN_DIR, render
    from test_integrator import make_cornell

    failures = []
    imgs = {"cornell_64_8spp": make_cornell(
        "wavefront", RenderConfig(blue_noise=True), size=64
    ).render_frame(samples=8)}
    for name in ("config2_64_8spp", "config3_64_8spp"):
        imgs[name] = render(name, engine="wavefront")
    for name, img in imgs.items():
        golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
        rmse = float(np.sqrt(((img - golden.astype(np.float32)) ** 2
                              ).mean()))
        log(card, f"golden {name}: RMSE {rmse:.2e} (bound {GOLDEN_RMSE:g})")
        if not rmse < GOLDEN_RMSE or not np.isfinite(img).all():
            failures.append(f"golden {name}: RMSE {rmse}")

    rs, _ = build("megakernel", seed)
    t0 = time.time()
    mega = rs.render_frame(status=RenderStatus.RESET, samples=1)
    log(card, f"megakernel 1080p 1 spp (compile + render) "
              f"{time.time() - t0:.1f} s")
    diff = np.abs(wave_frame - mega)
    rmse = float(np.sqrt((diff ** 2).mean()))
    moved = float((diff.max(axis=-1) > 1e-2).mean())
    log(card, f"1080p wavefront vs megakernel: RMSE {rmse:.2e} (bound "
              f"{FRAME_RMSE:g}), pixels moved > 1e-2: {moved:.2e} (bound "
              f"{FRAME_MOVED_FRAC:g}), means {wave_frame.mean():.4f} / "
              f"{mega.mean():.4f}")
    if not (rmse < FRAME_RMSE and moved < FRAME_MOVED_FRAC):
        failures.append(f"1080p frame vs megakernel: RMSE {rmse}, moved "
                        f"{moved}")
    return failures


def phase_four(seed: int, card: str) -> list[str]:
    """The smoke scene at 1080p tiled over four cards vs one card."""
    import jax

    from rfw_tpu.config import RenderConfig
    from rfw_tpu.render import RenderStatus

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    frames = {}
    for n_dev in (1, 4):
        rs, _ = build("wavefront", seed, RenderConfig(n_devices=n_dev))
        t0 = time.time()
        rs.render_frame(samples=1)
        log(card, f"{n_dev} card(s): warm-up {time.time() - t0:.1f} s")
        times = []
        for _ in range(3):
            t0 = time.time()
            frames[n_dev] = rs.render_frame(status=RenderStatus.RESET,
                                            samples=1)
            times.append(1e3 * (time.time() - t0))
        log(card, f"{n_dev} card(s): 1-spp 1080p frames "
                  f"{', '.join(f'{t:.1f}' for t in times)} ms")
    rmse = float(np.sqrt(((frames[4] - frames[1]) ** 2).mean()))
    log(card, f"tiled (4 cards) vs one card: RMSE {rmse:.2e} "
              f"(bound {TILED_RMSE:g})")
    ok = rmse < TILED_RMSE and np.isfinite(frames[4]).all()
    return [] if ok else [f"tiled frame vs one card: RMSE {rmse}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="render the tiled frame on four cards only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import rfw_tpu  # noqa: F401  (fails outside a checkout)

    devs, card = phase_device()
    failures = []
    if args.four:
        failures += phase_four(args.seed, card)
    else:
        rs, t0 = setup_scene(args.seed, card)
        failures += phase_kernels(rs, card, args.seed)
        reset, fails = phase_main_path(rs, t0, card)
        failures += fails
        del rs
        failures += phase_oracle(args.seed, card, reset)
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
