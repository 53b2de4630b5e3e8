"""A/B of the wavefront engine's intersector on one GPU: ms/sample of the
seeded interior at 1920x1080 (the bench scene), alternating A, B, B, A in
one process, then a profiler trace of one visit frame reduced to device
time per kernel (the visit enumeration's share of it included).

    python tools/intersector_ab.py [A B]      # default: visit bvh

Writes chiprun_out/intersector_ab.json beside the printed lines.
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import bounce_rays, card_label, primary_rays  # noqa: E402
from rfw_tpu.render.intersectors import FACTORIES  # noqa: E402
from rfw_tpu.render import RenderStatus  # noqa: E402
from rfw_tpu.scene.interior import build_interior  # noqa: E402
from rfw_tpu.system import RenderSystem  # noqa: E402

SPP = 4


def trace_events(trace_dir: str) -> list:
    """(name, hlo_op, start_ns, end_ns) of every event on a GPU plane of
    the one trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = ev.stats
                stats = dict(stats.items() if hasattr(stats, "items")
                             else stats)
                out.append((ev.name, str(stats.get("hlo_op", ev.name)),
                            ev.start_ns, ev.end_ns))
    return out


def busy_ms(events) -> tuple[float, float]:
    """(union of event intervals, first start to last end), in ms."""
    iv = sorted((s, e) for _, _, s, e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    window = max(e for _, e in iv) - iv[0][0] if iv else 0
    return total / 1e6, window / 1e6


def scope_ops(hlo_text: str, scope: str) -> set:
    """Names of the HLO instructions whose metadata places them under the
    named scope ``scope`` (how trace events map back to source)."""
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"[^\"]*"
                     + re.escape(scope))
    return {m.group(1) for m in map(pat.match, hlo_text.splitlines()) if m}


def traced(fn, trace_parent):
    """Run ``fn`` once under the profiler; return its GPU events."""
    with tempfile.TemporaryDirectory(dir=trace_parent) as d:
        jax.profiler.start_trace(d)
        jax.block_until_ready(fn())
        jax.profiler.stop_trace()
        return trace_events(d)


def main() -> None:
    names = sys.argv[1:3] or ["visit", "bvh"]
    if jax.devices()[0].platform != "gpu":
        sys.exit("intersector_ab: no GPU")
    card = card_label()
    print(f"card: {card}", flush=True)
    rs = RenderSystem("wavefront")
    build_interior(rs, seed=0)
    rs.camera.resize(1920, 1080)
    runs = []
    for name in (names[0], names[1], names[1], names[0]):
        rs.set_setting("intersector", name)
        t0 = time.time()
        rs.render_frame(samples=1)
        warm = time.time() - t0
        t0 = time.time()
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=SPP)
        rs.finish_frame()
        ms = 1e3 * (time.time() - t0) / SPP
        runs.append({"intersector": name, "ms_per_sample": ms,
                     "warm_s": warm})
        print(f"[{card}] {name}: {ms:.1f} ms/sample ({SPP} spp window; "
              f"warm-up incl. compile {warm:.1f} s)", flush=True)
    rs.set_setting("intersector", names[0])
    rs.render_frame(samples=1)
    tmp = os.environ.get("TMPDIR")

    def one_sample():
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=1)
        return rs.finish_frame()

    ev = traced(one_sample, tmp)
    busy, window = busy_ms(ev)
    per_op = {}
    for name, op, s0, s1 in ev:
        per_op[op] = per_op.get(op, 0.0) + (s1 - s0) / 1e6
    top = dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:20])
    print(f"[{card}] trace of one {names[0]} sample: device busy "
          f"{busy:.1f} of {window:.1f} ms (idle share "
          f"{1 - busy / max(window, 1e-9):.3f})", flush=True)
    for k, v in list(top.items())[:12]:
        print(f"[{card}]   {v:9.2f} ms  {k[:100]}", flush=True)

    # one closest-hit launch on a scattered depth-1 batch: the share of
    # the enumeration (fused XLA), the candidate sort and the kernel
    eng = rs.context
    scene, cfg = eng._scene, eng.config
    o, d = primary_rays(rs)
    ref = jax.jit(lambda s, o, d: FACTORIES["bvh"](cfg).closest(s, o, d))(
        scene, jnp.asarray(o), jnp.asarray(d))
    bo, bd = bounce_rays(scene, o, d, np.asarray(ref[0]),
                         np.asarray(ref[1]), np.random.default_rng(0))
    visit = FACTORIES["visit"](cfg)
    compiled = jax.jit(lambda s, o, d: visit.closest(s, o, d)).lower(
        scene, bo, bd).compile()
    hlo = compiled.as_text()
    jax.block_until_ready(compiled(scene, bo, bd))
    ev = traced(lambda: compiled(scene, bo, bd), tmp)
    launch, _ = busy_ms(ev)
    shares = {}
    for scope in ("visit_enumerate", "visit_sort", "visit_closest"):
        ops = scope_ops(hlo, scope)
        shares[scope] = sum((s1 - s0) / 1e6 for name, op, s0, s1 in ev
                            if op in ops or scope in name)
    print(f"[{card}] one visit closest-hit launch, {bo.shape[0]} bounce "
          f"rays: device busy {launch:.2f} ms; by scope "
          f"{ {k: round(v, 2) for k, v in shares.items()} }", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "intersector_ab.json"),
              "w") as f:
        json.dump({"card": card, "runs": runs,
                   "sample_trace": {"busy_ms": busy, "window_ms": window,
                                    "top_ops_ms": top},
                   "bounce_launch": {"rays": int(bo.shape[0]),
                                     "busy_ms": launch,
                                     "scope_ms": shares}}, f, indent=1)


if __name__ == "__main__":
    main()
