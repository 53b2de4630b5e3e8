"""The path-tracing integrator: one sample for every pixel, fully jitted.

Functional reimplementation of the reference's wavefront loop — host loop
CUDART/src/Context.cpp:65-159 + shade kernel Kernels.cu:571-794 — with the
stage structure preserved (ray-gen → [intersect → shade → NEE/occlude] per
bounce) but atomic queues replaced by masks: every pixel's path lives at a
fixed lane, dead lanes are masked out. XLA fuses the masked stages; the
injected intersector does the heavy traversal.

The integrator is engine-agnostic: engines inject an ``intersector`` (a pair
of closest/occluded callables), which is how one integrator serves the
bruteforce / megakernel(BVH) / wavefront engines — the rebuild's
answer to the reference's seven backends sharing one BSDF/shading header set.

Structure: the per-depth loop body is the standalone ``depth_stage`` over
an explicit ``PathState``. ``trace_sample`` composes the stages inside one
jit (the fused path);
``render/wavefront_driver.py`` composes the same stages with lane
COMPACTION between depths (the reference's atomic-queue wavefront
compaction, Kernels.cu:640,747,788, re-expressed as sort/gather — RNG is
keyed by pixel id, so results are permutation-invariant).
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops import light_sampling, raygen, rng
from ..ops.bsdf import get as get_bsdf
from ..ops.bsdf.common import (clamp_intensity, dot3, safe_origin,
                               survival_probability)
from ..ops.shade import get_shading_data


def _keep(*arrays):
    """A cheap scalar that data-depends on every input, so truncated
    stages cannot have their tail dead-code-eliminated by XLA."""
    acc = jnp.float32(0.0)
    for a in arrays:
        af = a.astype(jnp.float32)
        acc = acc + jnp.sum(jnp.where(jnp.isinf(af), 1.0, 0.0))
    return acc


class Intersector(NamedTuple):
    closest: Callable    # (scene, O, D, t_max=None) -> (t, prim, u, v)
    occluded: Callable   # (scene, O, D, dist) -> bool mask
    # dist/t_max of 0 marks a lane dead: intersectors cull it for free


class PathState(NamedTuple):
    """Per-lane path state between depths. Lanes are freely permutable:
    every random draw is keyed by ``pid`` (+ sample/depth), so compaction
    sorts preserve bitwise results per pixel."""

    origin: jnp.ndarray       # (N, 3)
    direction: jnp.ndarray    # (N, 3)
    throughput: jnp.ndarray   # (N, 3)
    radiance: jnp.ndarray     # (N, 3) accumulated along the path
    last_pdf: jnp.ndarray     # (N,)
    spec_bounce: jnp.ndarray  # (N,) bool — IS_SPECULAR path flag
    last_n: jnp.ndarray       # (N, 3) shading normal at previous vertex
    alive: jnp.ndarray        # (N,) bool
    pid: jnp.ndarray          # (N,) uint32 absolute pixel id


def _sky_texel(scene, d):
    """Direction → (x, y) equirect texel (Kernels.cu:593-601, Debevec)."""
    pix = scene["skybox"]["pixels"]
    h, w = pix.shape[0], pix.shape[1]
    u = (w * 0.5 * (1.0 + jnp.arctan2(d[..., 0], -d[..., 2])
                    * (1.0 / math.pi))).astype(jnp.int32)
    v = (h * (jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
              * (1.0 / math.pi))).astype(jnp.int32)
    return jnp.clip(u, 0, w - 1), jnp.clip(v, 0, h - 1)


def sample_skybox(scene, d):
    """Equirect miss lookup."""
    if "skybox" not in scene:
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    x, y = _sky_texel(scene, d)
    return scene["skybox"]["pixels"][y, x]


def skybox_pdf(scene, d):
    """Solid-angle pdf the envmap importance sampler would assign to d."""
    x, y = _sky_texel(scene, d)
    return scene["skybox"]["pdf"][y, x]


def sample_skybox_with_pdf(scene, d):
    """Miss radiance + IS pdf in ONE texel gather (bounce-depth MIS needs
    both; the packed (H, W, 4) ``pixpdf`` plane halves the per-op gather
    bill vs separate pixels/pdf lookups — engines.set_sky builds it)."""
    sky = scene["skybox"]
    x, y = _sky_texel(scene, d)
    if "pixpdf" in sky:
        row = sky["pixpdf"][y, x]
        return row[..., 0:3], row[..., 3]
    return sky["pixels"][y, x], sky["pdf"][y, x]


def sample_envmap(scene, r):
    """Inverse-CDF envmap sample: uniform r → (direction, pdf, radiance).

    Completes the importance sampling the reference declared but never
    implemented (skybox.h:37-39 dead CDF/PDF fields)."""
    sky = scene["skybox"]
    pix = sky["pixels"]
    h, w = pix.shape[0], pix.shape[1]
    idx = jnp.searchsorted(sky["flat_cdf"], r)
    idx = jnp.clip(idx, 0, h * w - 1)
    y = idx // w
    x = idx % w
    # texel center → direction (inverse of the Debevec mapping)
    u = (x.astype(jnp.float32) + 0.5) / w
    v = (y.astype(jnp.float32) + 0.5) / h
    phi = (2.0 * u - 1.0) * math.pi
    theta = v * math.pi
    sin_t = jnp.sin(theta)
    d = jnp.stack([sin_t * jnp.sin(phi), jnp.cos(theta),
                   -sin_t * jnp.cos(phi)], axis=-1)
    return d, sky["pdf"][y, x], pix[y, x]


def _no_nan(x):
    return jnp.where(jnp.isnan(x), 0.0, x)


def _scrub(x, mask, stats, config):
    """Zero NaN contributions (the reference's inline guards,
    Kernels.cu:603,638,686,744,785). With ``config.debug_checks`` the
    count of SELECTED lanes that needed scrubbing lands in
    ``stats["nan_scrubbed"]`` — SURVEY §5's NaN sanitizer mode: the
    always-on guard keeps production output clean, debug mode makes
    numeric regressions visible instead of silently zeroed."""
    if config.debug_checks:
        bad = jnp.any(jnp.isnan(x), axis=-1) & mask
        stats["nan_scrubbed"] = stats.get("nan_scrubbed", 0) + jnp.sum(bad)
    return _no_nan(x)


def _tile_permutation(width: int, n: int, tile: int = 16):
    """Static pixel→lane permutation grouping 16×16 image tiles into
    contiguous lanes. Row-major lanes put 256 consecutive pixels of ONE
    row in a block — a long thin strip whose ray envelope crosses far more
    BVH cells than a square tile's (the Pallas cull works per 256-ray
    block envelope). Returns (perm, inv) as numpy int32, or None when the
    range isn't tileable."""
    if n % width != 0:
        return None
    rows = n // width
    if rows < tile or width < tile:
        return None
    y, x = np.divmod(np.arange(n, dtype=np.int64), width)
    key = (((y // tile) * (width // tile + 1) + x // tile) * (tile * tile)
           + (y % tile) * tile + (x % tile))
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def make_path_state(scene, view, width: int, height: int, sample_index,
                    config: RenderConfig, pid, pixel_cache=None) -> PathState:
    """Ray-gen + fresh path state for the lanes in ``pid`` (absolute
    pixel ids, any order). ``pixel_cache`` optionally supplies the
    sample-invariant per-pixel raygen values (see raygen)."""
    bn_mask = scene.get("blue_noise")
    use_bn = config.blue_noise and bn_mask is not None
    origin, direction = raygen.generate_primary_rays(
        view, width, height, sample_index,
        blue_noise_mask=bn_mask if use_bn else None, pixel_ids=pid,
        pixel_cache=pixel_cache)
    n = pid.shape[0]
    return PathState(
        origin=origin, direction=direction,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        last_pdf=jnp.ones(n, jnp.float32),
        spec_bounce=jnp.zeros(n, dtype=bool),
        last_n=direction,
        alive=jnp.ones(n, dtype=bool),
        pid=pid)


def depth_stage(scene, view, state: PathState, width: int, depth: int,
                sample_index, probe_lane, config: RenderConfig,
                intersector: Intersector, tex_flags=None,
                sort_rays: bool | None = None, height: int | None = None,
                depth_t=None):
    """One depth of the wavefront loop: closest hit → shade (sky/emissive)
    → NEE + occlusion → extension BSDF sample.

    ``depth`` is static (blue-noise dims and env-NEE gating are
    compile-time). ``probe_lane`` is the lane index to probe (depth 0
    only; pass 0 otherwise). ``sort_rays`` overrides the intersector's
    coherence sort (None = legacy policy: sort iff depth > 0 — the
    compacted driver passes False for pre-sorted streams).

    ``depth_t`` (optional) is a TRACED depth scalar: ONE compiled body
    then serves every bounce depth 1..max_path_length — the main XLA
    compile-time lever (one-jit whole-sample programs otherwise inline
    max_path_length copies of this stage). When given, ``depth`` acts
    only as the static template class (must be >= 1; primary rays keep
    the static depth-0 body) and every depth-dependent value is computed from ``depth_t``:
    RNG stream seeds, blue-noise dimension constants (via static per-depth
    tables indexed by depth_t — bitwise-identical to the static bodies),
    env-NEE / MIS gates (traced masks over a fixed launch shape), and
    final-depth extension liveness (extension is computed, then masked).

    Returns (state, stats, probe, aux): stats {"ray_count", "shadow_count"}
    for this depth; probe (3,) and aux planes are None unless depth == 0.
    """
    n = state.pid.shape[0]
    if depth_t is not None:
        assert depth >= 1, "traced-depth mode serves bounce depths only"
        depth_t = jnp.asarray(depth_t, jnp.int32)
    d_rng = depth if depth_t is None else depth_t   # RNG stream key
    # Stage-truncation profiling hook (§5 tracing): RFW_STAGE_TRUNC=k
    # cuts this stage after phase k (1 closest, 2 shading data,
    # 3 emissive/sky, 4 NEE math pre-occlusion, 5 NEE+occlusion) so
    # per-phase device cost is attributable by differencing. Read at
    # TRACE time — rebuild the jit after changing it. 0 (default) = off.
    _STAGE_TRUNC = int(os.environ.get("RFW_STAGE_TRUNC", "0"))
    bsdf = get_bsdf(config.bsdf)
    clamp_v = jnp.float32(config.firefly_clamp)
    lights = scene["lights"]
    bn_mask = scene.get("blue_noise")
    use_bn = config.blue_noise and bn_mask is not None

    (origin, direction, throughput, radiance, last_pdf, spec_bounce,
     last_n, alive, pid) = state
    px = (pid % jnp.uint32(width)).astype(jnp.int32)
    py = (pid // jnp.uint32(width)).astype(jnp.int32)
    probe = None
    aux = None
    stats = {}

    # dead lanes carry t_max 0: the intersectors' per-ray culls drop
    # them before any treelet work (mask-only wavefront compaction)
    ray_tmax = jnp.where(alive, jnp.float32(1e30), 0.0)
    # primary rays arrive in pixel order (coherent) — skip the sort
    do_sort = (depth > 0) if sort_rays is None else sort_rays
    # depth 0 arrives in pixel-tile order: tight block envelopes let the
    # visit intersector enumerate per-block instead of per-ray
    t, prim, u, v = intersector.closest(scene, origin, direction,
                                        ray_tmax, sort=do_sort,
                                        coherent=depth == 0)
    prim = jnp.where(alive, prim, -1)
    stats["ray_count"] = jnp.sum(alive)

    if _STAGE_TRUNC == 1:   # profiling: closest hit only
        radiance = radiance.at[:, 0].add(_keep(t, prim, u, v))
        return (PathState(origin, direction, throughput, radiance,
                          last_pdf, spec_bounce, last_n, alive, pid),
                stats, probe, aux)

    miss = prim < 0
    # ---- skybox on miss (Kernels.cu:592-610) ----
    env_nee_active = (config.envmap_nee and config.variance_reduction
                      and "skybox" in scene
                      and "pdf" in scene.get("skybox", {}))

    def env_depth_ok(d: int) -> bool:
        return config.envmap_nee_max_depth < 0 or \
            d <= config.envmap_nee_max_depth

    def env_depth_ok_t(d):
        """Traced-depth variant of env_depth_ok (returns a traced bool)."""
        if config.envmap_nee_max_depth < 0:
            return jnp.bool_(True)
        return d <= config.envmap_nee_max_depth

    if (env_nee_active and depth > 0
            and (depth_t is not None or env_depth_ok(depth - 1))):
        # MIS against envmap NEE at the previous vertex (no-op for
        # specular bounces, which shot no NEE ray). One packed gather
        # serves both the radiance and the pdf.
        sky, e_pdf = sample_skybox_with_pdf(scene, direction)
        if depth_t is None:
            denom_m = jnp.where(spec_bounce, last_pdf, last_pdf + e_pdf)
        else:
            # traced gate: the previous vertex shot an env NEE ray only
            # if its depth passed the config cutoff
            mis_ok = env_depth_ok_t(depth_t - 1)
            denom_m = jnp.where(spec_bounce | ~mis_ok, last_pdf,
                                last_pdf + e_pdf)
    else:
        sky = sample_skybox(scene, direction)
        denom_m = last_pdf
    contrib = throughput * sky / jnp.maximum(denom_m, 1e-20)[..., None]
    contrib = clamp_intensity(_scrub(contrib, alive & miss, stats, config),
                              clamp_v)
    radiance = radiance + jnp.where((alive & miss)[..., None], contrib,
                                    0.0)
    alive = alive & ~miss
    prim_safe = jnp.maximum(prim, 0)

    hit_pos = origin + direction * t[..., None]
    cone_width = view["spread_angle"] * t
    stoch_seed = None
    if config.texture_filter == "stochastic":
        stoch_seed = rng.wang_hash(
            rng.path_seed(pid, sample_index, d_rng)
            ^ jnp.uint32(0x7FEB352D))
    sd, n_geom, i_n, t_vec, b_vec, alpha_cut = get_shading_data(
        scene, prim_safe, u, v, direction, cone_width,
        tex_flags=tex_flags, tex_filter=config.texture_filter,
        stoch_seed=stoch_seed)
    # alpha cutout (Kernels.cu:636-648): the hit is transparent — the
    # ray continues unchanged through the surface on the next bounce
    alpha_cut = alpha_cut & alive

    if _STAGE_TRUNC == 2:   # profiling: + shading data (textures)
        radiance = radiance.at[:, 0].add(_keep(
            sd["color"], sd["roughness"], n_geom, i_n, t_vec, b_vec,
            alpha_cut))
        return (PathState(origin, direction, throughput, radiance,
                          last_pdf, spec_bounce, last_n, alive, pid),
                stats, probe, aux)

    if depth == 0:
        # aux feature buffers for the denoiser (ops/denoise.py)
        aux = {"normal": jnp.where(miss[..., None], 0.0, i_n),
               "depth": jnp.where(miss, 0.0, t)}
        # probe readback (Kernels.cu:628-633). Gather the probed lane's
        # prim FIRST: indexing tri_instance[prim_safe][lane] gathers the
        # whole (R,) plane twice (~6 ms each at 305k rows) for 2 scalars.
        probe_prim = prim_safe[probe_lane]
        probe = jnp.stack([
            scene["tri_instance"][probe_prim].astype(jnp.float32),
            scene["tri_prim"][probe_prim].astype(jnp.float32),
            jnp.where(miss[probe_lane], jnp.float32(-1.0),
                      t[probe_lane]),
        ])

    # ---- emissive hit terminates path (Kernels.cu:651-692) ----
    emissive = jnp.any(sd["color"] > 1.0, axis=-1) & ~alpha_cut
    d_dot_nl = -dot3(direction, n_geom)
    if depth == 0:
        e_contrib = sd["color"]
    elif not config.variance_reduction:
        e_contrib = throughput * sd["color"] \
            / jnp.maximum(last_pdf, 1e-20)[..., None]
    else:
        if "tri_pack" in scene:
            # same (R, 32) row gather as get_shading_data — XLA CSEs
            # the duplicate, so area/light-idx come for free
            _row = scene["tri_pack"][prim_safe]
            tri_area_v = _row[:, 26]
            tri_lidx_v = _row[:, 27].astype(jnp.int32)
        else:
            tri_area_v = scene["tri_area"][prim_safe]
            tri_lidx_v = scene["tri_light_idx"][prim_safe]
        light_pdf = light_sampling.calculate_light_pdf(
            direction, t, tri_area_v, n_geom)
        pick_prob = light_sampling.light_pick_prob(
            tri_lidx_v, lights, origin, last_n, hit_pos)
        denom = last_pdf + light_pdf * pick_prob
        mis_c = throughput * sd["color"] / jnp.maximum(
            denom, 1e-20)[..., None]
        mis_c = jnp.where((denom > 0)[..., None], mis_c, 0.0)
        spec_c = throughput * sd["color"] / jnp.maximum(
            last_pdf, 1e-20)[..., None]
        e_contrib = jnp.where(spec_bounce[..., None], spec_c, mis_c)
    e_contrib = jnp.where((d_dot_nl > 0)[..., None], e_contrib, 0.0)
    e_contrib = clamp_intensity(
        _scrub(e_contrib, alive & emissive, stats, config), clamp_v)
    radiance = radiance + jnp.where((alive & emissive)[..., None],
                                    e_contrib, 0.0)
    alive = alive & ~emissive

    if _STAGE_TRUNC == 3:   # profiling: + sky/emissive radiance
        return (PathState(origin, direction, throughput, radiance,
                          last_pdf, spec_bounce, last_n, alive, pid),
                stats, probe, aux)

    # ---- fix normals, apply postponed pdf (Kernels.cu:698-703) ----
    flip = jnp.where(dot3(direction, n_geom) > 0, -1.0, 1.0)
    n_geom = n_geom * flip[..., None]
    i_n = i_n * flip[..., None]
    backfacing = flip < 0
    throughput_predpdf = throughput   # alpha lanes keep the postponed pdf
    throughput = throughput / jnp.maximum(last_pdf, 1e-20)[..., None]

    spec_mat = sd["roughness"] < config.min_roughness
    # Salt the shade-stage stream: path_seed(pid, sample, 0) is exactly
    # the primary-ray seed, so drawing NEE randoms from it would make
    # the light sample a deterministic function of the AA jitter —
    # a correlation that biases direct lighting by ~2% (the reference
    # has the same collision in its no-blue-noise fallback,
    # Kernels.cu:699 vs :385; blue-noise dims hide it there).
    seed = rng.wang_hash(
        rng.path_seed(pid, sample_index, d_rng) ^ jnp.uint32(0x9E3779B9))

    # ---- NEE (Kernels.cu:705-756) ----
    if config.variance_reduction:
        if use_bn and depth_t is not None:
            # traced-depth body: per-depth dimension constants come from
            # static tables indexed by depth_t — bitwise-equal to the
            # static per-depth bodies (same f64→f32 roundings, same
            # shift-field elements; only slice-vs-gather differs)
            dcap = config.max_path_length
            dims0 = np.array([4 + 2 * d for d in range(dcap + 1)])
            k_off = jnp.asarray(((dims0 // 2) * 0.38196601)
                                .astype(np.float32))[depth_t]
            if bn_mask.ndim == 3:   # stack: one row gather for both dims
                brow = rng.blue_noise_shift_row(bn_mask, px, py)
                nd = bn_mask.shape[2]
                col0 = jnp.asarray((dims0 % nd).astype(np.int32))[depth_t]
                col1 = jnp.asarray(((dims0 + 1) % nd)
                                   .astype(np.int32))[depth_t]
                s0 = jnp.take(brow, col0, axis=1)
                s1 = jnp.take(brow, col1, axis=1)
            else:
                size = bn_mask.shape[0]
                offs = np.array(
                    [list(rng._dim_offsets(4 + 2 * d, size))
                     + list(rng._dim_offsets(5 + 2 * d, size))
                     for d in range(dcap + 1)], np.int32)
                o = jnp.asarray(offs)[depth_t]
                s0 = bn_mask[(py + o[1]) % size, (px + o[0]) % size]
                s1 = bn_mask[(py + o[3]) % size, (px + o[2]) % size]
            r0 = rng.blue_noise_from_shift_koff(s0, sample_index, k_off, 0)
            r1 = rng.blue_noise_from_shift_koff(s1, sample_index, k_off, 1)
            seed, (h0, h1) = rng.random_floats(seed, 2)
            r0 = jnp.where(sample_index < config.blue_noise_spp_cutoff,
                           r0, h0)
            r1 = jnp.where(sample_index < config.blue_noise_spp_cutoff,
                           r1, h1)
        elif use_bn:
            # distinct dimension pair per depth (Kernels.cu uses
            # 4 + 4*pathLength) — reusing dims 4/5 at every depth
            # correlates the light samples across bounces
            d0_, d1_ = 4 + 2 * depth, 5 + 2 * depth
            if bn_mask.ndim == 3:   # stack: one row gather for both dims
                brow = rng.blue_noise_shift_row(bn_mask, px, py)
                nd = bn_mask.shape[2]
                r0 = rng.blue_noise_from_shift(
                    brow[:, d0_ % nd], sample_index, d0_)
                r1 = rng.blue_noise_from_shift(
                    brow[:, d1_ % nd], sample_index, d1_)
            else:
                r0 = rng.blue_noise_sample(bn_mask, px, py, sample_index,
                                           d0_)
                r1 = rng.blue_noise_sample(bn_mask, px, py, sample_index,
                                           d1_)
            seed, (h0, h1) = rng.random_floats(seed, 2)
            r0 = jnp.where(sample_index < config.blue_noise_spp_cutoff,
                           r0, h0)
            r1 = jnp.where(sample_index < config.blue_noise_spp_cutoff,
                           r1, h1)
        else:
            seed, (r0, r1) = rng.random_floats(seed, 2)
        ls = light_sampling.random_point_on_light(
            lights, r0, r1, hit_pos, i_n,
            importance_sample=config.importance_sample_lights)
        l_vec = ls["position"] - hit_pos
        dist = jnp.sqrt(jnp.maximum(dot3(l_vec, l_vec), 1e-20))
        l_dir = l_vec / dist[..., None]
        n_dot_l = dot3(l_dir, i_n)
        s_val, s_pdf = bsdf.evaluate_bsdf(sd, i_n, t_vec, b_vec,
                                          -direction, l_dir)
        # MIS balance with BSDF sampling only for area lights — a BSDF
        # ray can never hit a delta light (see light_sampling docstring)
        denom = (jnp.where(ls["is_delta"], 0.0, s_pdf)
                 + ls["light_pdf"] * ls["pick_prob"])
        nee = (throughput * s_val * ls["radiance"]
               * (n_dot_l / jnp.maximum(denom, 1e-20))[..., None])
        want_shadow = (alive & ~spec_mat & ~alpha_cut & (n_dot_l > 0)
                       & (ls["light_pdf"] > 0) & (s_pdf > 0))
        nee = clamp_intensity(_scrub(nee, want_shadow, stats, config),
                              clamp_v)
        s_origin = safe_origin(hit_pos, n_geom)
        s_dist = jnp.where(want_shadow,
                           dist - 2.0 * config.geometry_epsilon, 0.0)
        stats["shadow_count"] = jnp.sum(want_shadow)

        if _STAGE_TRUNC == 4:   # profiling: + NEE math, no occlusion
            radiance = radiance.at[:, 0].add(_keep(
                nee, s_origin, s_dist, want_shadow))
            return (PathState(origin, direction, throughput, radiance,
                              last_pdf, spec_bounce, last_n, alive, pid),
                    stats, probe, aux)

        # ---- envmap NEE (new capability; reference skybox.h:37-39
        # declares the tables but never fills them) ----
        # traced-depth bodies compile the fused 2n launch iff ANY bounce
        # depth shoots env NEE rays; per-depth gating is then a traced
        # mask (dead lanes cost the intersector nothing)
        bounce_env = (env_nee_active and
                      (env_depth_ok(depth) if depth_t is None else
                       (config.envmap_nee_max_depth < 0
                        or config.envmap_nee_max_depth >= 1)))
        if bounce_env:
            il = config.env_nee_interleave
            if il > 1 and height is not None:
                # interleaved sampling with PER-TILE evaluation: only
                # ceil(W/tb)*ceil(H/tb) distinct env samples exist, so the
                # inverse-CDF searchsorted (a ~17-step binary-search gather
                # chain over the 131k-texel CDF) runs on the tiny tile
                # table instead of per lane;
                # lanes fetch their tile's (dir, pdf, radiance) with ONE
                # row gather. Bitwise-identical to the per-lane original:
                # the tile seed recipe is unchanged.
                tb = max(int(round(il ** 0.5)), 1)
                tiles_x = (width + tb - 1) // tb
                tiles_y = (height + tb - 1) // tb
                tid = jnp.arange(tiles_x * tiles_y, dtype=jnp.uint32)
                gseed_t = rng.wang_hash(
                    rng.path_seed(tid, sample_index, d_rng)
                    ^ jnp.uint32(0x517CC1B7))
                _, re_t = rng.random_float(gseed_t)
                ed_t, ep_t, er_t = sample_envmap(scene, re_t)
                pack = jnp.concatenate(
                    [ed_t, ep_t[:, None], er_t], axis=1)    # (T, 7)
                gid = ((py // tb).astype(jnp.int32) * tiles_x
                       + (px // tb).astype(jnp.int32))
                row = pack[gid]
                e_dir, e_pdf, e_rad = row[:, 0:3], row[:, 3], row[:, 4:7]
            elif il > 1:
                # interleaved sampling (Keller & Heidrich): one env
                # sample per sqrt(il) x sqrt(il) IMAGE tile, derived
                # from absolute pixel coords — identical regardless
                # of chunking or multi-chip tiling (keeps tiled ==
                # single-device bitwise). A 16x16 tile is exactly one
                # intersector lane block, so its occlusion rays are
                # parallel → coherent blocks for the envelope cull.
                # Unbiased: every pixel applies a validly-distributed
                # env sample with its own BSDF weight; only the noise
                # is tile-correlated and averages out over samples.
                tb = max(int(round(il ** 0.5)), 1)
                gid = ((py // tb).astype(jnp.uint32)
                       * jnp.uint32((width + tb - 1) // tb)
                       + (px // tb).astype(jnp.uint32))
                gseed = rng.wang_hash(
                    rng.path_seed(gid, sample_index, d_rng)
                    ^ jnp.uint32(0x517CC1B7))
                _, re = rng.random_float(gseed)
                e_dir, e_pdf, e_rad = sample_envmap(scene, re)
            elif depth_t is None:
                seed, re = rng.random_float(seed)
                e_dir, e_pdf, e_rad = sample_envmap(scene, re)
            else:
                # traced gate: only advance the lane seed at depths that
                # actually shoot env NEE (bitwise-matches the static
                # bodies, where gated depths skip this draw entirely)
                seed_n, re = rng.random_float(seed)
                seed = jnp.where(env_depth_ok_t(depth_t), seed_n, seed)
                e_dir, e_pdf, e_rad = sample_envmap(scene, re)
            e_cos = dot3(e_dir, i_n)
            eb_val, eb_pdf = bsdf.evaluate_bsdf(
                sd, i_n, t_vec, b_vec, -direction, e_dir)
            e_denom = e_pdf + eb_pdf
            e_contrib = (throughput * eb_val * e_rad
                         * (e_cos / jnp.maximum(e_denom, 1e-20))[..., None])
            e_want = (alive & ~spec_mat & ~alpha_cut & (e_cos > 0)
                      & (e_pdf > 0) & (eb_pdf > 0))
            if depth_t is not None and config.envmap_nee_max_depth >= 0:
                e_want = e_want & env_depth_ok_t(depth_t)
            e_contrib = clamp_intensity(
                _scrub(e_contrib, e_want, stats, config), clamp_v)
            if "shadow_count" in stats:
                # env shadow rays ride the fused occlusion launch below —
                # count them (reference RenderStats counts every shadow
                # ray actually traced, context.h:50-72)
                stats["shadow_count"] = stats["shadow_count"] \
                    + jnp.sum(e_want)
            # one fused occlusion launch for light + envmap shadow rays
            # (halves per-call overhead). Depth 0 is launched unsorted
            # with per-ray enumeration: under interleave=256 each block
            # is one 16x16 tile sharing ONE env direction, and light rays
            # converge — blocks arrive coherent, so the global 2n sort is
            # overhead, and the envelope enumeration's conservative lists
            # grow near-full on the scattered rows.
            # Bounce depths (scattered origins) keep the sorted launch.
            occ2 = intersector.occluded(
                scene,
                jnp.concatenate([s_origin, s_origin]),
                jnp.concatenate([l_dir, e_dir]),
                jnp.concatenate([s_dist, jnp.where(e_want, 1e30, 0.0)]),
                sort=depth > 0, coherent=False)
            occ, e_occ = occ2[:n], occ2[n:]
            radiance = radiance + jnp.where(
                (want_shadow & ~occ)[..., None], nee, 0.0)
            radiance = radiance + jnp.where(
                (e_want & ~e_occ)[..., None], e_contrib, 0.0)
        else:
            # depth-0 shadow rays start at pixel-ordered (coherent) hit
            # points — skip the sort there (and use the envelope enum);
            # bounce origins are compaction-sorted (coherent by origin)
            # with directions converging on lights; whether the launch's
            # own re-sort still pays there is unmeasured on the GPU
            occ = intersector.occluded(scene, s_origin, l_dir, s_dist,
                                       sort=depth > 0, coherent=depth == 0)
            radiance = radiance + jnp.where(
                (want_shadow & ~occ)[..., None], nee, 0.0)

    if _STAGE_TRUNC == 5:   # profiling: + occlusion, no extension
        return (PathState(origin, direction, throughput, radiance,
                          last_pdf, spec_bounce, last_n, alive, pid),
                stats, probe, aux)

    if depth_t is None and depth >= config.max_path_length:
        # final depth: no extension rays
        state = PathState(origin, direction, throughput, radiance,
                          last_pdf, spec_bounce, last_n,
                          jnp.zeros_like(alive), pid)
        return state, stats, probe, aux

    # ---- extension: sample BSDF (Kernels.cu:760-794) ----
    seed, (r3, r4) = rng.random_floats(seed, 2)
    b_val, wi, new_pdf, _stype = bsdf.sample_bsdf(
        sd, i_n, n_geom, t_vec, b_vec, -direction, t, backfacing, r3, r4)
    new_throughput = (throughput * b_val
                      * jnp.abs(dot3(i_n, wi))[..., None])
    if config.russian_roulette:
        # survival divide + kill together (the reference divides without
        # killing — Kernels.cu:783 — which is biased bright; with its
        # MAX_PATH_LENGTH=2 default the damage is bounded, here it isn't)
        survival = jnp.clip(survival_probability(throughput), 1e-6, 1.0)
        seed, rr = rng.random_float(seed)
        alive = alive & ((rr <= survival) | alpha_cut)
        new_throughput = new_throughput / survival[..., None]
    valid = ((new_pdf > 1e-6) & ~jnp.isnan(new_pdf)
             & jnp.all(new_throughput >= 0.0, axis=-1)
             & ~jnp.any(jnp.isnan(new_throughput), axis=-1))
    alive = alive & (valid | alpha_cut)
    # alpha lanes pass straight through: state unchanged, origin nudged
    # past the surface along the ray (Kernels.cu:641-644)
    ac = alpha_cut[..., None]
    throughput = jnp.where(ac, throughput_predpdf, new_throughput)
    last_pdf = jnp.where(alpha_cut, last_pdf, new_pdf)
    spec_bounce = jnp.where(alpha_cut, spec_bounce, spec_mat)
    last_n = jnp.where(ac, last_n, i_n)
    origin = jnp.where(
        ac, hit_pos + direction * config.geometry_epsilon,
        safe_origin(hit_pos, n_geom))
    direction = jnp.where(ac, direction, wi)
    if depth_t is not None:
        # traced final depth: the extension above was computed but its
        # lanes die here — radiance is untouched by extension, so the
        # frame matches the static no-extension body exactly
        alive = alive & (depth_t < config.max_path_length)

    state = PathState(origin, direction, throughput, radiance, last_pdf,
                      spec_bounce, last_n, alive, pid)
    return state, stats, probe, aux


def trace_sample(scene, view, width: int, height: int, sample_index,
                 probe_index, config: RenderConfig,
                 intersector: Intersector, pixel_offset=0,
                 n_pixels: int | None = None, tex_flags=None):
    """Trace one sample per pixel (fused: all depths in one jit).
    Returns (radiance (N,3), probe (3,), stats dict, aux). ``sample_index``/
    ``probe_index`` are traced scalars so spp accumulation does not
    recompile.

    ``pixel_offset``/``n_pixels`` select a contiguous pixel range of the
    full image — the multi-chip tile path (parallel/tiles.py) gives each
    chip its own row block; probe_index is relative to the range.
    """
    n = n_pixels if n_pixels is not None else width * height

    # lanes hold pixels in 16×16-tile order (square ray-block envelopes for
    # the intersector cull); results are scattered back to row-major at
    # the end. The permutation is static — pixel_offset/width/n are python.
    tp = _tile_permutation(width, n)
    if tp is not None:
        perm_np, inv_np = tp
        pid = (jnp.asarray(perm_np.astype(np.uint32))
               + jnp.asarray(pixel_offset, jnp.uint32))
        inv_lane = jnp.asarray(inv_np)
    else:
        pid = (jnp.arange(n, dtype=jnp.uint32)
               + jnp.asarray(pixel_offset, jnp.uint32))
        inv_lane = None

    state = make_path_state(scene, view, width, height, sample_index,
                            config, pid)
    probe = jnp.zeros(3, jnp.float32)
    aux = {"normal": jnp.zeros((n, 3), jnp.float32),
           "depth": jnp.zeros(n, jnp.float32)}
    stats = {}
    probe_lane = (probe_index if inv_lane is None
                  else inv_lane[probe_index])

    # depth 0 (static body: ray-gen policy, probe, aux, coherent flags)
    state, stats_d0, probe, aux = depth_stage(
        scene, view, state, width, 0, sample_index, probe_lane,
        config, intersector, tex_flags=tex_flags, height=height)
    for k, v in stats_d0.items():
        stats[f"{k}_0"] = v

    # depths 1..D share ONE traced-depth body under a fori_loop (the
    # same XLA compile-time lever as the compacted driver — unrolled
    # static bodies multiplied the fused program's compile time by
    # max_path_length; see depth_stage depth_t)
    dmax = config.max_path_length
    if dmax >= 1:
        stats_arr0 = {k: jnp.zeros(dmax + 1, jnp.int32) for k in stats_d0}

        def depth_body(dd, carry):
            st, stats_arr = carry
            st, st_d, _, _ = depth_stage(
                scene, view, st, width, 1, sample_index, jnp.int32(0),
                config, intersector, tex_flags=tex_flags,
                sort_rays=True, height=height, depth_t=dd)
            stats_arr = {k: stats_arr[k].at[dd].set(st_d[k])
                         for k in stats_arr}
            return st, stats_arr

        import jax
        state, stats_arr = jax.lax.fori_loop(
            1, dmax + 1, depth_body, (state, stats_arr0))
        for k in stats_arr:
            for dd in range(1, dmax + 1):
                stats[f"{k}_{dd}"] = stats_arr[k][dd]

    radiance = state.radiance
    if inv_lane is not None:   # tiled lanes → row-major pixel order
        radiance = radiance[inv_lane]
        aux = {k: v[inv_lane] for k, v in aux.items()}
    if config.debug_checks:
        # SURVEY §5 sanitizer analog: the always-on _no_nan guards zero
        # NaNs silently; debug mode additionally REPORTS them so numeric
        # regressions surface during development.
        def _nan_warn(n_bad):
            if int(n_bad) > 0:
                from ..utils import logger
                logger.warning("integrator: %d non-finite radiance "
                               "components this sample", int(n_bad))
        import jax
        jax.debug.callback(_nan_warn, jnp.sum(~jnp.isfinite(radiance)))
    return radiance, probe, stats, aux
