"""Compacted wavefront driver: per-depth whole-frame stages with lane
compaction between depths, compiled as ONE XLA program per sample.

The reference's wavefront loop compacts its ray queues with atomic
counters between bounces (CUDART Kernels.cu:640,747,788 extensionRays /
shadowRays + InitCounters per depth) so later bounces only pay for live
paths, and its host loop reads those counters back every depth
(Context.cpp:109-147). A host-side Python loop per depth pays per-chunk
dispatches, slice and concat dispatches and live-count readback bubbles;
this driver keeps all of it on the device:

* the WHOLE SAMPLE is one ``jit``: ray-gen + every depth + compaction +
  finalize, ONE dispatch, zero device→host syncs inside a sample;
* each depth chunk-loops via ``lax.fori_loop`` with a **traced** trip
  count ``ceil(live / chunk)`` — the live count never visits the host,
  and later depths still only pay for live lanes (static shapes: every
  chunk body is the same compiled block on a dynamic row offset);
* between depths the per-lane ``PathState`` lives packed in one (N, 18)
  f32 matrix (ints/bools bitcast) and compacts by ONE stable
  multi-operand ``lax.sort`` keyed (dead, direction octant, dir Morton,
  origin Morton) — live lanes first, coherence-ordered for the
  intersector (whose own per-launch sort is then skipped);
* after the last depth one sort by pixel id restores row-major order.

Bitwise identity: every random draw is keyed by pixel id (+ sample,
depth), so lane permutation does not change any pixel's arithmetic — with
a deterministic intersector the compacted frame equals the fused
``trace_sample`` frame exactly (tests/test_wavefront_driver.py).

``step_profiled`` keeps the host-side per-depth loop (forced syncs) to
fill the per-stage RenderStats times (context.h:50-72 parity) — engines
run it for the last sample of a multi-sample frame so live stats stay
fresh at ~1/samples of the sync cost.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops.compaction import ray_sort_keys
from ..utils import Timer
from .integrator import (Intersector, PathState, _tile_permutation,
                         depth_stage, make_path_state)


def _pack_state(state: PathState):
    """PathState → (N, 18) f32 matrix (ints/bools bitcast/encoded) for a
    single-row-gather permutation. Column order puts the fields a DEAD
    lane still owes the frame (radiance, flags, pid) LAST (historical:
    the argsort-path compaction gathers dead tail rows at 5 columns)."""
    f = jnp.float32
    flags = (state.alive.astype(f) + 2.0 * state.spec_bounce.astype(f))
    # pid bitcast is safe here: pids < 2^31 are never NaN bit patterns
    # (XLA may canonicalize NaN payloads in any op — the visit_intersect
    # regroup-merge bug), and the column only moves through slices /
    # sort-carries, never arithmetic (which could flush subnormals)
    pid_f = jax.lax.bitcast_convert_type(state.pid, f)
    cols = [state.origin, state.direction, state.throughput,
            state.last_n, state.last_pdf[:, None],
            state.radiance, flags[:, None], pid_f[:, None]]
    return jnp.concatenate(cols, axis=1)          # (N, 18) → pad-free


_TAIL_COL = 13   # radiance(13:16), flags(16), pid(17)


def _unpack_state(m) -> PathState:
    flags = m[:, 16]
    return PathState(
        origin=m[:, 0:3], direction=m[:, 3:6], throughput=m[:, 6:9],
        radiance=m[:, 13:16], last_n=m[:, 9:12], last_pdf=m[:, 12],
        spec_bounce=flags >= 2.0,
        alive=jnp.mod(flags, 2.0) >= 1.0,
        pid=jax.lax.bitcast_convert_type(m[:, 17], jnp.uint32))


def _compact_keys_of(scene, state: PathState):
    tl = scene["treelets"]
    lo = tl["scene_lo"] if "scene_lo" in tl else tl["bmin"].min(axis=0)
    hi = tl["scene_hi"] if "scene_hi" in tl else tl["bmax"].max(axis=0)
    keys = ray_sort_keys(state.origin, state.direction, lo, hi)
    return keys + jnp.where(state.alive, jnp.uint32(0),
                            jnp.uint32(1) << 28)


def _compact_sort_packed(scene, packed):
    """Sort-carry compaction on the packed (N, 18) state: ONE stable
    multi-operand lax.sort permutes the state in-sort instead of argsort
    + row gathers. A lane iota as the
    second key makes the order exactly the stable argsort order, so the
    two compaction paths are bitwise-identical."""
    state = _unpack_state(packed)
    keys = _compact_keys_of(scene, state)
    lane = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    ops = jax.lax.sort(
        (keys, lane) + tuple(packed[:, i] for i in range(packed.shape[1])),
        dimension=0, num_keys=2)
    return jnp.stack(ops[2:], axis=1), jnp.sum(state.alive)


def _compact_gather_packed(scene, packed):
    """argsort + ONE (N, 18) row gather — the legacy compaction kept for
    the bitwise sort-vs-gather oracle (test_compact_via_sort_bitwise)."""
    state = _unpack_state(packed)
    keys = _compact_keys_of(scene, state)
    order = jnp.argsort(keys).astype(jnp.int32)
    return packed[order], jnp.sum(state.alive)


def _compact_prefix(scene, packed, prev_nc, chunk, compact_packed):
    """Compact only the first ``prev_nc * chunk`` rows — the rows the
    previous depth's stages actually touched (it ran ``prev_nc`` chunks).
    Rows beyond are an already-compacted DEAD tail: nothing revives a
    lane, every live row after depth d sits inside depth d's processed
    prefix, and live keys sort below dead keys (bit 28), so the live
    prefix this produces is IDENTICAL to a full-frame compact; only the
    arrangement of dead rows differs — and dead rows reach the frame
    solely through the pid-keyed finalize sort (radiance/pid/alive are
    never mutated for dead lanes; see depth_stage), so frames stay
    bitwise-equal while the sort pays ~prev_nc/nc0 of the full cost.
    ``prev_nc`` is TRACED: lax.switch picks among static prefix sizes."""
    n = packed.shape[0]
    nc0 = n // chunk

    def mk(k: int):
        if k == 0:
            return lambda p: (p, jnp.int32(0))
        if k == nc0:
            return lambda p: compact_packed(scene, p)

        def br(p):
            head, live = compact_packed(scene, p[:k * chunk])
            return jnp.concatenate([head, p[k * chunk:]]), live
        return br

    return jax.lax.switch(jnp.clip(prev_nc, 0, nc0),
                          [mk(k) for k in range(nc0 + 1)], packed)


def _stage_chunk_factory(width, height, cfg, intersector, tex_flags):
    def stage_chunk(scene, view, state_c, sample_index, probe_rel,
                    depth: int, depth_t=None):
        return depth_stage(scene, view, state_c, width, depth,
                           sample_index, probe_rel, cfg, intersector,
                           tex_flags=tex_flags, sort_rays=False,
                           height=height, depth_t=depth_t)
    return stage_chunk


def make_sample_body(width: int, height: int, n: int, chunk: int,
                     cfg: RenderConfig, intersector: Intersector,
                     tex_flags, invert_aux: bool = True):
    """The whole-sample compacted-wavefront program as a PURE function —
    ray-gen + every depth + compaction + finalize, no host syncs, traced
    live counts. The single-chip ``WavefrontDriver`` jits it directly;
    the multi-chip route (parallel/tiles.make_driver_engine_step) calls
    it per tile inside ``shard_map``, so BASELINE config 5 runs the SAME
    flagship program per chip instead of the fused fallback. ``n`` is the
    lane count this body owns (full frame, or one tile's row block); ``pid_all`` carries absolute pixel ids so RNG and
    finalize order are tiling-invariant.

    Signature: body(scene, accumulator (n,3), pid_all (n,), inv_all
    ((n,) i32 | None), view, sample_index, probe_lane, pixel_cache=None) →
    (accumulator', probe (3,), stats dict, aux dict). ``pixel_cache``
    optionally carries the sample-invariant per-pixel raygen values in
    pid order (see ops.raygen) — the single-chip driver precomputes them
    once; the multi-chip tile path computes them inline."""
    assert n % chunk == 0
    stage_chunk = _stage_chunk_factory(width, height, cfg, intersector,
                                       tex_flags)
    compact_packed = (_compact_sort_packed if cfg.compact_via_sort
                      else _compact_gather_packed)

    def sample_body(scene, accumulator, pid_all, inv_all, view,
                    sample_index, probe_lane, pixel_cache=None):
        nc0 = n // chunk
        stats_all = {}

        # depth 0: ray-gen fused into the stage; static chunk count.
        def d0_body(c, carry):
            packed, probe, stats, aux_n, aux_d = carry
            off = c * chunk
            pid_c = jax.lax.dynamic_slice(pid_all, (off,), (chunk,))
            pc_c = (None if pixel_cache is None else jax.tree.map(
                lambda a: jax.lax.dynamic_slice_in_dim(a, off, chunk, 0),
                pixel_cache))
            st_c = make_path_state(scene, view, width, height,
                                   sample_index, cfg, pid_c,
                                   pixel_cache=pc_c)
            rel = probe_lane - off
            in_chunk = (rel >= 0) & (rel < chunk)
            out, st, probe_c, aux_c = stage_chunk(
                scene, view, st_c, sample_index,
                jnp.where(in_chunk, rel, 0), 0)
            packed = jax.lax.dynamic_update_slice(
                packed, _pack_state(out), (off, 0))
            probe = jnp.where(in_chunk, probe_c, probe)
            stats = {k: stats[k] + v for k, v in st.items()}
            aux_n = jax.lax.dynamic_update_slice(
                aux_n, aux_c["normal"], (off, 0))
            aux_d = jax.lax.dynamic_update_slice(
                aux_d, aux_c["depth"], (off,))
            return packed, probe, stats, aux_n, aux_d

        stats0 = {"ray_count": jnp.int32(0)}
        if cfg.variance_reduction:
            stats0["shadow_count"] = jnp.int32(0)
        if cfg.debug_checks:
            stats0["nan_scrubbed"] = jnp.int32(0)
        carry = (jnp.zeros((n, 18), jnp.float32),
                 jnp.zeros(3, jnp.float32), stats0,
                 jnp.zeros((n, 3), jnp.float32),
                 jnp.zeros(n, jnp.float32))
        packed, probe, st0, aux_n, aux_d = jax.lax.fori_loop(
            0, nc0, d0_body, carry)
        for k, v in st0.items():
            stats_all[f"{k}_0"] = v

        # depths 1..D: ONE traced-depth body compiled once and
        # fori-looped over depth (the compile-time lever: unrolled
        # per-depth bodies multiply compile time; see
        # integrator.depth_stage depth_t)
        dmax = cfg.max_path_length
        stats_arr0 = {k: jnp.zeros(dmax + 1, jnp.int32)
                      for k in stats0}

        def depth_body(d, carry):
            packed, prev_nc, stats_arr = carry
            packed, live = _compact_prefix(scene, packed, prev_nc, chunk,
                                           compact_packed)

            def d_body(c, carry2):
                packed, stats = carry2
                off = c * chunk
                rows = jax.lax.dynamic_slice(packed, (off, 0),
                                             (chunk, 18))
                out, st, _, _ = stage_chunk(
                    scene, view, _unpack_state(rows), sample_index,
                    jnp.int32(0), 1, depth_t=d)
                packed = jax.lax.dynamic_update_slice(
                    packed, _pack_state(out), (off, 0))
                stats = {k: stats[k] + v for k, v in st.items()}
                return packed, stats

            # TRACED trip count: later depths only run ceil(live/chunk)
            # chunks; 0 live lanes → 0 iterations (the all-dead break
            # for free, no host readback anywhere in the sample)
            nc_d = (live.astype(jnp.int32) + (chunk - 1)) // chunk
            packed, st_d = jax.lax.fori_loop(
                0, nc_d, d_body, (packed, stats0))
            stats_arr = {k: stats_arr[k].at[d].set(st_d[k])
                         for k in stats_arr}
            return packed, nc_d, stats_arr

        packed, _, stats_arr = jax.lax.fori_loop(
            1, dmax + 1, depth_body, (packed, jnp.int32(nc0), stats_arr0))
        for k in stats_arr:
            for d in range(1, dmax + 1):
                stats_all[f"{k}_{d}"] = stats_arr[k][d]

        # finalize: restore pixel order by ONE pid-keyed sort-carry
        pid_f = packed[:, 17]
        pid_u = jax.lax.bitcast_convert_type(pid_f, jnp.uint32)
        srt = jax.lax.sort(
            (pid_u, packed[:, 13], packed[:, 14], packed[:, 15]),
            dimension=0, num_keys=1)
        radiance = jnp.stack(srt[1:4], axis=1)
        accumulator = accumulator + radiance
        # aux planes (denoiser guide normals/depths) are only CONSUMED
        # when the denoise setting is on; with invert_aux=False they stay
        # in tile-permuted lane order and the caller inverts once per
        # FRAME at denoise time instead of paying two ~2M-row gathers
        # per SAMPLE here (engines.render_frame). The multi-chip tile
        # path keeps invert_aux=True — its all-gather needs local pixel
        # order per tile.
        if invert_aux and inv_all is not None:
            aux_n = aux_n[inv_all]
            aux_d = aux_d[inv_all]
        return (accumulator, probe, stats_all,
                {"normal": aux_n, "depth": aux_d})

    return sample_body


class WavefrontDriver:
    """Builds and caches the jitted whole-sample step (plus the host-loop
    profiled step) for one (width, height, config, intersector) combo."""

    def __init__(self, width: int, height: int, config: RenderConfig,
                 intersector: Intersector, tex_flags, chunk: int):
        self.width = width
        self.height = height
        self.config = config
        self.chunk = chunk
        n = width * height
        assert n % chunk == 0, "engine picks chunk counts dividing n"
        self.n = n
        tp = _tile_permutation(width, n)
        if tp is not None:
            perm_np, inv_np = tp
            self._pid_np = perm_np.astype(np.uint32)
            self._inv_np = inv_np
        else:
            self._pid_np = np.arange(n, dtype=np.uint32)
            self._inv_np = None
        # device-resident lane tables (args, not jit closure constants —
        # closure numpy constants bake into the HLO as literals)
        self._pid_dev = jax.device_put(jnp.asarray(self._pid_np))
        self._inv_dev = (jax.device_put(jnp.asarray(self._inv_np))
                         if self._inv_np is not None else None)
        # sample-invariant per-pixel raygen values (ops.raygen
        # pixel_cache): sx/sy here, blue-noise shift rows lazily per
        # scene (_pixel_cache) — saves the repeated per-sample u32
        # div/mod + (N, dims) gather
        self._sx_dev = jax.device_put(jnp.asarray(
            (self._pid_np % np.uint32(width)).astype(np.int32)))
        self._sy_dev = jax.device_put(jnp.asarray(
            (self._pid_np // np.uint32(width)).astype(np.int32)))
        self._pc = None
        self._pc_key = object()
        self._intersector = intersector
        self._tex_flags = tex_flags
        self.depth_times: list[float] = []
        self._build_fns(config, intersector, tex_flags)

    # -- jitted building blocks ------------------------------------------------

    def _build_fns(self, config, intersector, tex_flags):
        width, height, chunk, n = (self.width, self.height, self.chunk,
                                   self.n)
        cfg = config
        compact_packed = (_compact_sort_packed if cfg.compact_via_sort
                          else _compact_gather_packed)
        stage_chunk = _stage_chunk_factory(width, height, cfg, intersector,
                                           tex_flags)

        # ---- the whole-sample program (module-level pure body) -----------
        # invert_aux=False: the engine inverts aux once per frame at
        # denoise time (aux_inverse), not per sample
        sample_body = make_sample_body(width, height, n, chunk, cfg,
                                       intersector, tex_flags,
                                       invert_aux=False)
        self._sample_fn = jax.jit(sample_body, donate_argnums=(1,))
        self._use_bn = cfg.blue_noise

        # ---- multi-sample batch: ONE dispatch for a whole CONVERGE
        # request (the multi-chunk analog of engines.py's single-chunk
        # multi_step). n_samples is TRACED, so every sample count shares
        # one compiled program (a static count would recompile the ~6 min
        # terminal-side program per count — bench warms with samples=2
        # and times samples=4). The init carry comes from eval_shape so
        # the sample body is traced exactly once (inside the loop);
        # probe/stats/aux keep the host loop's last-sample-wins
        # overwrite semantics.
        def multi_body(scene, accumulator, pid_all, inv_all, view,
                       sample_index0, probe_lane, n_samples,
                       pixel_cache=None):
            shapes = jax.eval_shape(sample_body, scene, accumulator,
                                    pid_all, inv_all, view, sample_index0,
                                    probe_lane, pixel_cache)
            init = (accumulator,) + tuple(
                jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), t)
                for t in shapes[1:])

            def body(k, carry):
                return sample_body(scene, carry[0], pid_all, inv_all,
                                   view,
                                   sample_index0 + k.astype(jnp.uint32),
                                   probe_lane, pixel_cache)

            return jax.lax.fori_loop(0, n_samples, body, init)

        self._multi_fn = jax.jit(multi_body, donate_argnums=(1,))

        # ---- host-loop building blocks (profiled path + tools) -------------
        @jax.jit
        def init_fn(scene, view, sample_index):
            return make_path_state(scene, view, width, height,
                                   sample_index, config, self._pid_dev)

        @jax.jit
        def stage0_fn(scene, view, pid_slice, sample_index, probe_lane):
            state = make_path_state(scene, view, width, height,
                                    sample_index, config, pid_slice)
            return stage_chunk(scene, view, state, sample_index,
                               probe_lane, 0)

        @jax.jit
        def stage_fn(scene, view, state, sample_index, probe_lane, depth):
            # depth is TRACED: the same compiled body serves every bounce
            # depth (matches the one-jit program's fori-looped body, so
            # step_profiled stats stay exactly equal to step's)
            return stage_chunk(scene, view, state, sample_index,
                               probe_lane, 1,
                               depth_t=jnp.asarray(depth, jnp.int32))

        @jax.jit
        def compact_fn(scene, state):
            packed, live = compact_packed(scene, _pack_state(state))
            return _unpack_state(packed), live

        @jax.jit
        def finalize_fn(state):
            order = jnp.argsort(state.pid).astype(jnp.int32)
            return state.radiance[order]

        # per-stage entry points of the profiled step
        @jax.jit
        def compact_keys_fn(scene, state):
            keys = _compact_keys_of(scene, state)
            order = jnp.argsort(keys).astype(jnp.int32)
            return order, jnp.sum(state.alive)

        @functools.partial(jax.jit, static_argnames=("m",))
        def compact_apply_fn(state, order, m):
            full = _pack_state(state)
            front = full[order[:m]]
            if m < full.shape[0]:
                tail_cols = full[:, _TAIL_COL:][order[m:]]
                tail = jnp.concatenate(
                    [jnp.zeros((tail_cols.shape[0], _TAIL_COL),
                               jnp.float32), tail_cols], axis=1)
                front = jnp.concatenate([front, tail], axis=0)
            return _unpack_state(front)

        self._init = init_fn
        self._stage0 = stage0_fn
        self._stage = stage_fn
        self._compact = compact_fn
        self._compact_keys = compact_keys_fn
        self._compact_apply = compact_apply_fn
        self._finalize = finalize_fn
        self._m_pred: dict[int, int] = {}   # kept for tools compatibility

    def _pixel_cache(self, scene):
        """Sample-invariant per-pixel raygen values (pid order): sx/sy
        always; blue-noise shift rows once per scene (the (N, dims)
        gather runs ONCE here instead of every sample). Cached by the
        blue-noise table's identity."""
        bn = scene.get("blue_noise") if self._use_bn else None
        key = id(bn) if bn is not None else None
        if self._pc is None or self._pc_key != key:
            pc = {"sx": self._sx_dev, "sy": self._sy_dev}
            if bn is not None and bn.ndim == 3:
                from ..ops.rng import blue_noise_shift_row
                pc["bn_row"] = jax.jit(blue_noise_shift_row)(
                    bn, self._sx_dev, self._sy_dev)
            self._pc = pc
            self._pc_key = key
        return self._pc

    def _slice(self, state: PathState, c: int) -> PathState:
        s, e = c * self.chunk, (c + 1) * self.chunk
        return jax.tree.map(lambda a: a[s:e], state)

    # -- production step: ONE dispatch per sample ------------------------------

    def step(self, scene, accumulator, view, sample_index, probe_index):
        """One sample for the whole frame in one jitted dispatch.
        Returns (accumulator, probe, stats, aux)."""
        probe_i = int(probe_index)
        probe_lane = (probe_i if self._inv_np is None
                      else int(self._inv_np[probe_i]))
        return self._sample_fn(scene, accumulator, self._pid_dev,
                               self._inv_dev, view,
                               jnp.uint32(sample_index),
                               jnp.int32(probe_lane),
                               self._pixel_cache(scene))

    def step_multi(self, scene, accumulator, view, sample_index,
                   probe_index, n_samples):
        """``n_samples`` samples in ONE jitted dispatch (traced sample
        count — all counts share one compiled program). Equal to looping
        ``step`` to float ulps; stats/probe/aux are the last sample's."""
        probe_i = int(probe_index)
        probe_lane = (probe_i if self._inv_np is None
                      else int(self._inv_np[probe_i]))
        return self._multi_fn(scene, accumulator, self._pid_dev,
                              self._inv_dev, view,
                              jnp.uint32(sample_index),
                              jnp.int32(probe_lane),
                              jnp.int32(n_samples),
                              self._pixel_cache(scene))

    # -- profiled step: host loop with per-depth syncs (RenderStats) -----------

    def step_profiled(self, scene, accumulator, view, sample_index,
                      probe_index):
        """Same sample, host-looped with a device sync per depth so the
        per-depth wall clock lands in ``depth_times`` (the reference's
        per-stage RenderStats, context.h:50-72 / CUDART Context.cpp:87-143).
        Engines run this for the LAST sample of a multi-sample frame.
        Frames agree with ``step`` to float ulps (same stage/compaction
        functions in the same order; different jit graphs fuse FMAs
        differently — tests/test_wavefront_driver.py)."""
        cfg = self.config
        n, chunk = self.n, self.chunk
        probe_i = int(probe_index)
        probe_lane = (probe_i if self._inv_np is None
                      else int(self._inv_np[probe_i]))
        state = None
        live = n
        stats: dict = {}
        probe = None
        aux_parts = []
        self.depth_times = []
        timer = Timer()
        for depth in range(cfg.max_path_length + 1):
            n_chunks = max(1, -(-live // chunk))
            parts = []
            for c in range(n_chunks):
                rel = probe_lane - c * chunk
                in_chunk = depth == 0 and 0 <= rel < chunk
                if depth == 0:
                    out, st, probe_c, aux_c = self._stage0(
                        scene, view,
                        self._pid_dev[c * chunk:(c + 1) * chunk],
                        sample_index, jnp.int32(rel if in_chunk else 0))
                else:
                    sl = self._slice(state, c)
                    out, st, probe_c, aux_c = self._stage(
                        scene, view, sl, sample_index,
                        jnp.int32(rel if in_chunk else 0), depth)
                parts.append(out)
                for k, v in st.items():
                    key = f"{k}_{depth}"
                    stats[key] = stats.get(key, 0) + v
                if in_chunk:
                    probe = probe_c
                if depth == 0:
                    aux_parts.append(aux_c)
            if state is None:
                state = jax.tree.map(
                    lambda *xs: jnp.concatenate(xs), *parts)
            else:
                tail = jax.tree.map(lambda a: a[n_chunks * chunk:], state)
                state = jax.tree.map(
                    lambda *xs: jnp.concatenate(xs), *parts, tail)
            if depth < cfg.max_path_length:
                state, live_dev = self._compact(scene, state)
                live = int(live_dev)  # forced sync: this is the profiler
            else:
                state.radiance.block_until_ready()
            self.depth_times.append(timer.elapsed())
            timer = Timer()
            if depth < cfg.max_path_length and live == 0:
                break
        radiance = self._finalize(state)
        accumulator = accumulator + radiance
        # lane order, like step(): the engine inverts at denoise time
        aux = jax.tree.map(lambda *xs: jnp.concatenate(xs), *aux_parts)
        return accumulator, probe, stats, aux

    def aux_inverse(self, aux):
        """Tile-permuted lane order → pixel order (apply once per frame,
        only when the denoiser consumes the aux planes)."""
        if self._inv_dev is None:
            return aux
        return {k: v[self._inv_dev] for k, v in aux.items()}
