"""Render configuration.

The reference splits configuration into compile-time defines
(/root/reference/RFW/system/context/rfw/context/settings.h:1-18) and a runtime
string key/value protocol (context/context.h:36-48). Here both tiers live in one
dataclass; engines additionally expose the queryable runtime-settings protocol
(see rfw_tpu/render/context.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration compiled into the render functions.

    Changing any field triggers re-jit of the engine's stages (the analog of
    recompiling the reference's kernels after editing settings.h).
    """

    # Path tracing (reference settings.h:3-8, CUDART/Context.cpp:50-51)
    max_path_length: int = 2          # MAX_PATH_LENGTH
    min_roughness: float = 0.01       # MIN_ROUGHNESS
    max_is_lights: int = 8            # MAX_IS_LIGHTS — potential-based light IS cap
    importance_sample_lights: bool = True   # IS_LIGHTS
    variance_reduction: bool = True   # VARIANCE_REDUCTION (NEE + MIS)
    firefly_clamp: float = 10.0       # clampValue (CUDART/Context.cpp:51)
    geometry_epsilon: float = 1e-5    # geometryEpsilon (CUDART/Context.cpp:50)
    t_epsilon: float = 1e-4           # T_EPSILON triangle-test epsilon
    russian_roulette: bool = True     # RR survival (Kernels.cu:783)

    # Sampling
    blue_noise: bool = True           # BLUENOISE — blue-noise mask for spp < 256
    blue_noise_spp_cutoff: int = 256

    # Textures (settings.h:3)
    mip_level_count: int = 5          # MIPLEVELCOUNT

    # Skybox / IBL importance sampling (settings.h:15-18). The reference
    # declares but never fills its envmap CDF tables (skybox.h:37-39);
    # here envmap NEE with MIS is implemented (BASELINE config 3).
    ibl_width: int = 512
    ibl_height: int = 256
    envmap_nee: bool = True
    # deepest path vertex that shoots an envmap NEE ray. Bounce-vertex env
    # NEE adds a SCATTERED occlusion launch per depth for a modest variance
    # win; BSDF-sampling MIS still collects bounced sky light unbiasedly at
    # deeper vertices. -1 = every vertex.
    envmap_nee_max_depth: int = 0
    # lanes sharing one envmap NEE sample (interleaved sampling, Keller &
    # Heidrich): 256 = one env direction per 16x16 pixel tile, which turns
    # the env occlusion launch from fully-scattered into near-parallel
    # coherent rays. Unbiased — per-pixel noise becomes per-tile noise
    # that averages out across samples. 0/1 = off.
    env_nee_interleave: int = 256
    # merge diffuse/normal/rough into one RGBA8 texture: with the default
    # STOCHASTIC filter this is ONE texel gather for all three maps vs
    # three (fetch_merged_stochastic), with no measurable bias.
    merged_material_atlas: bool = True
    # build two-level TLAS/BLAS tables into the device scene (reference
    # TopLevelBVH parity: instances move with a TLAS refit, no BLAS work).
    # The 'tlas' intersector (render/intersectors.py) consumes them; the
    # flattened world-space path stays the default for the other
    # intersectors.
    use_tlas: bool = False
    # run same-topology deformation updates (skinning/morphs) as ONE
    # jitted device function (scene_data.make_device_refit) instead of
    # the numpy host refit — sub-MB upload + device math per frame. Only
    # engages for intersectors that read the treelet tables; 'bvh'/'tlas'
    # fall back to the host refit.
    device_refit: bool = True
    # device deformation updates REBUILD the visit-cell structure each
    # call with a Morton sort of the deformed centroids (the LBVH-style
    # device rebuild, SURVEY §7) instead of keeping the original cell
    # membership: fresh cells every frame avoid refit's unbounded drift
    # in cull quality. False = classic refit
    # semantics (static membership, reference top_level_bvh.cpp:17-53).
    device_rebuild_cells: bool = True
    # consecutive deformation refits before a full rebuild restores BVH /
    # treelet cull quality (refit keeps topology while geometry drifts —
    # the reference refits unconditionally, top_level_bvh.cpp:17-53; a
    # periodic rebuild is strictly safer). 0 disables refitting entirely.
    max_refits: int = 64
    # texture filtering: "stochastic" (default: ONE tap per map whose
    # EXPECTATION is exactly the 8-tap trilinear filter — mip level and
    # bilinear corner chosen with probability equal to their filter
    # weight; unbiased, texture-frequency noise averages out with spp),
    # "trilinear" (deterministic 8 taps/map, the reference's filter),
    # "bilinear" (nearest mip, 4 taps), "nearest" (1 tap, point).
    # The reference gets filtering free from hardware samplers; here
    # every tap is an explicit gather from device memory.
    texture_filter: str = "stochastic"

    # Animation
    animation_enabled: bool = True

    # Numerics
    dtype: str = "float32"            # geometry + shading dtype
    # Debug instrumentation (SURVEY §5 sanitizer analog): when on, the
    # integrator asserts finite radiance per stage and the pair driver
    # reports rays whose traversal was truncated by its pass bounds
    # (normally silent). Also counts NaN contributions the
    # always-on guards scrub on SELECTED lanes into per-depth
    # "nan_scrubbed" stats and warns per frame (SURVEY §5 NaN sanitizer
    # mode). Costs a host callback per launch; off in production.
    debug_checks: bool = False

    # BSDF model (reference bsdf/bsdf.h:19-22: disney active; lambert and
    # microfacet selectable alternatives)
    bsdf: str = "disney"

    # Wavefront engine knobs (no reference analog)
    # devices to shard the frame across (image row-block tiles,
    # parallel/tiles.py). 0/1 = single device. >1 routes render_frame
    # through shard_map on a 1-D tile mesh — the SURVEY §2.9 "new
    # capability" reachable straight from the product ABI.
    n_devices: int = 0
    compaction: bool = True           # prefix-sum stream compaction between bounces
    compact_via_sort: bool = True     # carry the packed state through ONE
    #                                   multi-operand lax.sort (lane iota
    #                                   tie-break key == stable argsort
    #                                   order → bitwise-identical) instead
    #                                   of argsort + row gather.
    max_rays_per_pass: int = 1 << 19  # chunk big frames: bounds the
    #                                   per-launch device-memory temps
    treelet_size: int = 128           # triangles per dense-intersection
    #                                   treelet (cell) of the visit lists
    treelet_spatial: bool = True      # disjoint centroid-cell treelets (fast)
    #                                   vs SAH-subtree ranges (legacy)
    # visit-list intersector granule: "cell" (one K-tri cell per visit,
    # minimal dense work) or "super" (SUPER_G cells per visit — fewer,
    # fatter visits). See ops/visit_intersect.py.
    visit_granularity: str = "cell"
    profile_stages: bool = False      # fill per-depth RenderStats times by
    #                                   running the host-loop PROFILED step
    #                                   for the last sample of each frame.
    #                                   Costs a SECOND set of compiled
    #                                   programs; whole-frame time and all
    #                                   ray counts are filled either way.


DEFAULT_CONFIG = RenderConfig()
