"""Concrete engines implementing the EngineContext ABI.

The reference ships seven backends because CPUs/GPUs expose different
tracing APIs (SURVEY §2.5); on JAX one compute substrate remains, so the
engines here differ by *strategy*, preserving the cross-engine-comparison
oracle (SURVEY §4):

* ``bruteforce``  — exact O(R·T); ground truth for tiny scenes.
* ``megakernel``  — full path tracer on the 4-wide BVH gather traversal;
                    runs on CPU; the CPURT analog (and the test oracle).
* ``wavefront``   — flagship: same integrator, per-depth compacted
                    driver over the platform's default intersector
                    (``default_intersector``); the CUDART/VulkanRTX analog.
* ``direct``      — primary rays + NEE only, no bounces; the EmbreeRT/CPURT
                    "direct lighting" behavior (EmbreeRT/Context.cpp:228-259).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops import rng as rng_mod
from ..ops.tonemap import resolve_accumulator
from ..scene.mesh import TriangleSoA
from ..utils import Timer, logger
from . import scene_data
from .context import (EngineContext, RenderSetting, RenderStatus,
                      register_engine)
from .integrator import trace_sample
from .intersectors import FACTORIES

# (width, height, config, intersector, flags, chunk) → WavefrontDriver:
# engines come and go per RenderSystem; compiled program sets are
# process-wide (see _get_trace_fn)
_DRIVER_CACHE: dict = {}


class PathTracerEngine(EngineContext):
    """Shared machinery: scene bookkeeping, jit cache, accumulation."""

    default_intersector = "bvh"

    def __init__(self, config: RenderConfig | None = None):
        super().__init__(config)
        self._meshes: dict[int, TriangleSoA] = {}
        self._instances: dict[int, tuple[int, np.ndarray]] = {}
        self._materials: dict | None = None
        self._atlas: dict | None = None
        self._lights: dict | None = None
        self._light_overrides: dict = {}
        self._skybox: dict | None = None
        self._scene: dict | None = None
        self._dirty = True
        self._accumulator: jnp.ndarray | None = None
        self._sample_count = 0
        self._size: tuple[int, int] = (0, 0)
        self._probe_xy = (0, 0)
        self._probe_result = (-1, -1, -1.0)
        self._trace_fn = None
        self._pending = None
        self._intersector_name = self.default_intersector
        self._denoise = False
        self._mesh_versions: dict[int, int] = {}
        self._geo_key = None

    # -- uploads -------------------------------------------------------------

    def set_mesh(self, slot: int, triangles: TriangleSoA) -> None:
        if self._meshes.get(slot) is not triangles:
            self._mesh_versions[slot] = self._mesh_versions.get(slot, 0) + 1
        self._meshes[slot] = triangles
        self._dirty = True

    def set_instance(self, instance_id: int, mesh_slot: int,
                     transform: np.ndarray) -> None:
        self._instances[instance_id] = (mesh_slot,
                                        np.asarray(transform, np.float32))
        self._dirty = True

    def remove_instance(self, instance_id: int) -> None:
        self._instances.pop(instance_id, None)
        self._dirty = True

    def set_materials(self, device_materials) -> None:
        self._materials = device_materials
        self._dirty = True

    def set_textures(self, atlas) -> None:
        self._atlas = atlas
        self._dirty = True

    def set_lights(self, lights, overrides=None) -> None:
        self._lights = lights
        self._light_overrides = overrides or {}
        self._dirty = True

    def set_sky(self, pixels: np.ndarray) -> None:
        pixels = np.asarray(pixels, np.float32)
        self._skybox = {"pixels": pixels,
                        "size": np.array([pixels.shape[1], pixels.shape[0]],
                                         np.int32)}
        if self.config.envmap_nee:
            from ..scene.skybox import Skybox
            self._skybox.update(
                Skybox(pixels).build_importance_tables())
            # packed radiance+pdf plane: bounce-depth MIS reads both for
            # every lane — one (H, W, 4) gather instead of two
            self._skybox["pixpdf"] = np.concatenate(
                [pixels, np.asarray(self._skybox["pdf"],
                                    np.float32)[..., None]], axis=-1)
        self._dirty = True

    # -- scene build ---------------------------------------------------------

    def _instance_list(self) -> list:
        instances = [
            scene_data.InstancedMesh(
                triangles=self._meshes[slot], transform=tr,
                instance_id=iid, mesh_slot=slot)
            for iid, (slot, tr) in sorted(self._instances.items())
            if slot in self._meshes
        ]
        if not instances:  # implicit identity instance per mesh
            instances = [
                scene_data.InstancedMesh(
                    triangles=tris, transform=np.eye(4, dtype=np.float32),
                    instance_id=slot, mesh_slot=slot)
                for slot, tris in sorted(self._meshes.items())
            ]
        return instances

    def prewarm_instance_moves(self) -> None:
        """Compile AND first-execute the device-refit program now, so the
        first interactive instance move doesn't pay its compile. The
        refreshed scene is discarded;
        engine state is unchanged. No-op when the flagship device-refit
        path wouldn't be used (bvh/tlas intersectors refit on host)."""
        if (self._scene is None or self._dirty
                or not self.config.device_refit
                or "tlas" in self._scene
                or self._intersector_name in ("bvh", "tlas")
                or getattr(self, "_perm_host", None) is None):
            return
        instances = self._instance_list()
        if getattr(self, "_device_refit", None) is None:
            self._device_refit = scene_data.make_device_refit(
                self._scene, instances, self._perm_host, self.config)
        slot_planes = self._device_slot_planes(instances)
        out = self._device_refit(
            slot_planes, [im.transform for im in instances])
        jax.block_until_ready(out["tri_vertices"])

    def _device_slot_planes(self, instances) -> dict:
        """Object-space planes on DEVICE, keyed by mesh version: a
        transforms-only instance move re-uploads NOTHING (the per-slot
        planes are tens of MB at bench scale); a deformation (version
        bump) re-puts only changed slots."""
        if not hasattr(self, "_slot_planes_dev"):
            self._slot_planes_dev = {}
        slot_planes = {}
        for im in instances:
            ver = self._mesh_versions.get(im.mesh_slot, 0)
            cached = self._slot_planes_dev.get(im.mesh_slot)
            if cached is None or cached[0] != ver:
                cached = (ver, jax.device_put({
                    "vertices": im.triangles.vertices,
                    "normals": im.triangles.normals,
                    "gnormal": im.triangles.gnormal,
                    "tangent": im.triangles.tangent,
                    "bitangent": im.triangles.bitangent,
                }))
                self._slot_planes_dev[im.mesh_slot] = cached
            slot_planes[im.mesh_slot] = cached[1]
        return slot_planes

    def update(self) -> None:
        if not self._dirty:
            return
        if not self._meshes:
            raise RuntimeError("no meshes uploaded")
        if self._lights is None:
            from ..scene.lights import pack_lights
            self._lights = pack_lights([], [], [], [])
        if self._materials is None:
            from ..scene.materials import MaterialList
            self._materials = MaterialList().generate_device_materials()
        instances = self._instance_list()
        timer = Timer()
        # geometry rebuild (BVH/treelets/Woop) only when geometry inputs
        # changed — material/light/sky edits reuse the cached arrays
        # (the reference's dirty-bit granularity, system.cpp:247-433)
        structure_key = (
            tuple((im.instance_id, im.mesh_slot,
                   self._mesh_versions.get(im.mesh_slot, 0))
                  for im in instances),
            tuple(sorted(self._light_overrides.items())),
        )
        geo_key = (structure_key,
                   tuple(im.transform.tobytes() for im in instances))
        # version-free structure + per-instance triangle counts: if these
        # match, a mesh-version bump is a DEFORMATION (same topology) and
        # qualifies for the refit path (reference rebuild-vs-refit policy,
        # top_level_bvh.cpp:17-53)
        anim_key = (
            tuple((im.instance_id, im.mesh_slot) for im in instances),
            tuple(sorted(self._light_overrides.items())),
            tuple(im.triangles.vertices.shape[0] for im in instances),
        )
        if getattr(self, "_geo_key", None) == geo_key and self._scene:
            scene = dict(self._scene)
            scene["materials"] = self._materials
            scene["lights"] = self._lights
            if self._skybox is not None:
                scene["skybox"] = self._skybox
            if self._atlas is not None:
                scene["atlas"] = self._atlas["atlas"]
                scene["atlas_desc"] = self._atlas["desc"]
                if "matlas" in self._atlas:
                    scene["matlas"] = self._atlas["matlas"]
                    scene["matlas_desc"] = self._atlas["matlas_desc"]
                else:
                    scene.pop("matlas", None)
                    scene.pop("matlas_desc", None)
        elif (self.config.use_tlas and self._intersector_name == "tlas"
              and (getattr(self, "_geo_key", None) or (None,))[0]
              == structure_key
              and self._scene and getattr(self, "_perm_host", None)
              is not None):
            # transforms-only change under the TLAS intersector: refresh
            # world shading planes (cached permutation) + TLAS instance
            # tables — no BVH/treelet rebuild, no re-jit (reference
            # set_instance + TLAS-refit path, system.cpp:599-620)
            scene = scene_data.retransform_instances(
                dict(self._scene), instances, self._perm_host,
                pack_host=getattr(self, "_pack_host", None))
            scene["materials"] = self._materials
            scene["lights"] = self._lights
            if self._skybox is not None:
                scene["skybox"] = self._skybox
            self._geo_key = geo_key
        else:
            if not hasattr(self, "_shape_caps"):
                self._shape_caps = {}
            refit = None
            drift_free = False
            can_refit = (
                getattr(self, "_anim_key", None) == anim_key
                and self._scene
                and getattr(self, "_perm_host", None) is not None
                and getattr(self, "_refits", 0) < self.config.max_refits)
            if (can_refit and self.config.device_refit
                    and "tlas" not in self._scene
                    and self._intersector_name not in ("bvh", "tlas")):
                # device-side deformation path: one jitted refresh of the
                # shading planes + treelet tables; the wide-BVH arrays
                # are left stale (no flagship consumer — engines force a
                # rebuild when switching to 'bvh'/'tlas')
                if getattr(self, "_device_refit", None) is None:
                    self._device_refit = scene_data.make_device_refit(
                        self._scene, instances, self._perm_host,
                        self.config)
                refit = self._device_refit(
                    self._device_slot_planes(instances),
                    [im.transform for im in instances])
                # fresh Morton cells every call have NO refit drift, so
                # the max_refits quality backstop (and its periodic
                # full-SAH frame hitch — seconds at bench scale) does not
                # apply; interactive instance moves stay O(refit) forever
                drift_free = self.config.device_rebuild_cells
            elif can_refit and getattr(self, "_bvh_host", None) is not None:
                # same topology, new vertex data and/or transforms →
                # host refit instead of rebuild (no SAH, no re-jit)
                refit = scene_data.refit_deformed(
                    dict(self._scene), instances, self._perm_host,
                    self._bvh_host, self.config, self._shape_caps,
                    pack_host=getattr(self, "_pack_host", None))
            if refit is not None:
                if not drift_free:
                    self._refits = getattr(self, "_refits", 0) + 1
                scene = refit
                scene["materials"] = self._materials
                scene["lights"] = self._lights
                if self._skybox is not None:
                    scene["skybox"] = self._skybox
            else:
                scene = scene_data.build_device_scene_cached(
                    instances, self._materials, self._lights, self._skybox,
                    self._atlas, self.config,
                    area_light_overrides=self._light_overrides,
                    shape_caps=self._shape_caps)
                self._refits = 0
                self._device_refit = None   # new structure → recompile
            self._geo_key = geo_key
            self._anim_key = anim_key
        # merged-atlas consistency: the matlas path needs the per-material
        # mtex_id table; with it, every shading fetch reads the matlas and
        # the ~190 MB f32 atlas can ship as a 1-texel stub (halves upload
        # + HBM). WITHOUT it (direct-engine users who never set mtex_id),
        # drop the matlas so shading takes the real flat atlas — a stub +
        # real descriptors would silently fetch garbage.
        if scene.get("matlas") is not None:
            if self._materials and "mtex_id" in self._materials:
                scene["atlas"] = np.ones((1, 4), np.float32)
            else:
                scene.pop("matlas", None)
                scene.pop("matlas_desc", None)
        self._perm_host = scene.pop("_perm_host",
                                    getattr(self, "_perm_host", None))
        self._bvh_host = scene.pop("_bvh_host",
                                   getattr(self, "_bvh_host", None))
        self._pack_host = scene.pop("_pack_host",
                                    getattr(self, "_pack_host", None))
        if self.config.blue_noise:
            # pre-shifted per-dimension stack: shift lookups for all dims
            # of a pixel are one row gather (ops/rng.py blue_noise_stack)
            scene["blue_noise"] = rng_mod.blue_noise_stack()
        # re-jit only when the scene's pytree structure/shapes changed —
        # per-frame animation updates keep shapes and reuse the compiled
        # stages (the analog of the reference's persistent kernels)
        def shapes(tree):
            return jax.tree.map(
                lambda x: (getattr(x, "shape", None),
                           str(getattr(x, "dtype", ""))), tree)
        if self._scene is None or shapes(scene) != shapes(self._scene):
            self._trace_fn = None
        # aux entries (materials/lights/skybox/blue-noise) ride EVERY
        # update as numpy but change rarely — convert through an
        # identity-keyed device cache so a transforms-only instance move
        # re-uploads none of their few MB
        if not hasattr(self, "_aux_dev_cache"):
            self._aux_dev_cache = {}
        for aux_key in ("materials", "lights", "skybox", "blue_noise"):
            src = scene.get(aux_key)
            if src is None:
                continue
            ent = self._aux_dev_cache.get(aux_key)
            if ent is None or ent[0] is not src:
                ent = (src, jax.device_put(src))
                self._aux_dev_cache[aux_key] = ent
            scene[aux_key] = ent[1]
        # move the scene to device ONCE — numpy leaves would re-upload the
        # whole scene (100s of MB with textures) on every jitted call.
        # ONE batched device_put for every array leaf instead of one
        # transfer per leaf
        leaves, treedef = jax.tree.flatten(scene)
        arr_idx = [i for i, x in enumerate(leaves)
                   if isinstance(x, np.ndarray)]
        if arr_idx:
            put = jax.device_put([leaves[i] for i in arr_idx])
            for i, p in zip(arr_idx, put):
                leaves[i] = p
        self._scene = jax.tree.unflatten(treedef, leaves)
        self._dirty = False
        self._sample_count = 0       # scene changed ⇒ restart accumulation
        logger.debug("scene update: %d tris, %.1f ms",
                     scene["tri_vertices"].shape[0], timer.elapsed_ms())

    # -- render --------------------------------------------------------------

    def _integrator_config(self) -> RenderConfig:
        return self.config

    use_wavefront_driver = False   # per-depth compaction driver (flagship)

    def _get_trace_fn(self, width: int, height: int):
        mats = self._materials or {}

        def _any_bound(*keys):
            return bool(any(np.any(np.asarray(
                mats.get(k, np.array([-1]))) >= 0) for k in keys))

        tex_flags = {
            "diffuse": _any_bound("tex0_id"),
            "normal": _any_bound("tex1_id"),
            "rough": _any_bound("tex3_id"),
            # additive layers (reference 11-slot map surface,
            # getShadingData.h:162-206) — compiled in only when bound
            "diffuse_layers": _any_bound("tex5_id", "tex6_id"),
            "normal_layers": _any_bound("tex7_id", "tex8_id"),
        }
        # tex_flags are baked into the compiled stages: a value-only
        # material edit that binds/unbinds a slot class (same array
        # shapes, so update() keeps the cached fn) must still re-jit
        flags_key = tuple(sorted(tex_flags.items()))
        if (self._trace_fn is not None and self._size == (width, height)
                and getattr(self, "_tex_flags_key", None) == flags_key):
            return self._trace_fn
        self._tex_flags_key = flags_key
        cfg = self._integrator_config()
        intersector = FACTORIES[self._intersector_name](cfg)
        n_total = width * height
        n_chunks = max(1, -(-n_total // cfg.max_rays_per_pass))
        # equal chunks → one compiled shape; prefer chunks of whole image
        # rows so the integrator's 16x16-tile lane ordering stays available
        while height % n_chunks and n_chunks < height:
            n_chunks += 1
        if height % n_chunks:
            n_chunks = max(1, -(-n_total // cfg.max_rays_per_pass))
            while n_total % n_chunks:
                n_chunks += 1
        n_local = n_total // n_chunks

        if cfg.n_devices and cfg.n_devices > 1:
            # multi-chip tiles through the product ABI (SURVEY §2.9):
            # each device traces a contiguous row block under shard_map.
            # Wavefront engines run the FLAGSHIP compacted driver program
            # per chip (make_driver_engine_step); others the fused stages
            from ..parallel.mesh import make_tile_mesh
            from ..parallel.tiles import (make_driver_engine_step,
                                          make_engine_step)
            self._driver = None
            self._multi_step = None
            mesh = make_tile_mesh(cfg.n_devices)
            if self.use_wavefront_driver and cfg.compaction:
                self._trace_fn = make_driver_engine_step(
                    mesh, width, height, cfg, intersector, tex_flags)
            else:
                self._trace_fn = make_engine_step(mesh, width, height, cfg,
                                                  intersector, tex_flags)
            self._size = (width, height)
            return self._trace_fn

        if (self.use_wavefront_driver and cfg.compaction
                and n_chunks > 1):
            # multi-chunk frames: per-depth compacted driver (later
            # depths run ceil(live/chunk) chunks). Single-chunk frames
            # stay on the fused one-jit path — the driver's ~10 separate
            # dispatches + syncs dominate small interactive frames, and
            # with one chunk compaction cannot reduce work.
            # PROCESS-LEVEL driver cache: a new engine/RenderSystem with
            # the same (size, config, intersector, flags) reuses the
            # already-traced-and-compiled program set — a warm-session
            # scene swap pays upload + render only, not a re-trace
            # (warm time to first pixel; driver state is scene-keyed)
            from .wavefront_driver import WavefrontDriver
            dkey = (width, height, cfg, self._intersector_name,
                    flags_key, n_local)
            self._driver = _DRIVER_CACHE.get(dkey)
            if self._driver is None:
                self._driver = WavefrontDriver(width, height, cfg,
                                               intersector, tex_flags,
                                               n_local)
                _DRIVER_CACHE[dkey] = self._driver
            self._trace_fn = self._driver.step
            self._multi_step = None
            self._size = (width, height)
            return self._trace_fn
        self._driver = None

        @functools.partial(jax.jit, static_argnames=("n_pixels",))
        def chunk_step(scene, view, sample_index, probe_index, offset,
                       n_pixels):
            return trace_sample(
                scene, view, width, height, sample_index, probe_index,
                cfg, intersector, pixel_offset=offset, n_pixels=n_pixels,
                tex_flags=tex_flags)

        def step(scene, accumulator, view, sample_index, probe_index):
            probe = None
            stats_sum: dict = {}
            aux_parts = []
            for c in range(n_chunks):
                off = c * n_local
                rel_probe = jnp.clip(probe_index - off, 0, n_local - 1)
                radiance, probe_c, stats, aux = chunk_step(
                    scene, view, sample_index, rel_probe,
                    jnp.uint32(off), n_local)
                accumulator = accumulator.at[off:off + n_local].add(radiance)
                if probe is None or (off <= int(probe_index) < off + n_local):
                    probe = probe_c
                for k, v in stats.items():
                    stats_sum[k] = stats_sum.get(k, 0) + v
                aux_parts.append(aux)
            aux_all = jax.tree.map(
                lambda *xs: jnp.concatenate(xs), *aux_parts)
            return accumulator, probe, stats_sum, aux_all

        if n_chunks == 1:
            # single-chunk frames (the interactive case, BASELINE configs
            # 1-4): batch a whole multi-sample CONVERGE request into ONE
            # jitted fori_loop — one dispatch for N samples instead of N
            # (the per-dispatch overhead dominates small frames).
            # Bitwise == the per-sample loop: same trace_sample body per
            # sample_index, same accumulation order; stats/probe/aux are
            # the LAST sample's, exactly like the host loop's
            # `out = step_s(...)` overwrite semantics.
            @functools.partial(jax.jit, static_argnames=("n_samples",),
                               donate_argnums=(1,))
            def multi_step(scene, accumulator, view, sample_index0,
                           probe_index, n_samples):
                def one(si, acc):
                    radiance, probe_c, stats, aux = chunk_step(
                        scene, view, si, probe_index, jnp.uint32(0),
                        n_local)
                    return acc + radiance, probe_c, stats, aux

                acc, probe, stats, aux = one(sample_index0, accumulator)

                def body(k, carry):
                    acc, _, _, _ = carry
                    return one(sample_index0 + k.astype(jnp.uint32), acc)

                return jax.lax.fori_loop(1, n_samples, body,
                                         (acc, probe, stats, aux))

            self._multi_step = multi_step
        else:
            self._multi_step = None
        self._trace_fn = step
        self._size = (width, height)
        return step

    def render_frame(self, view, status: RenderStatus = RenderStatus.RESET,
                     samples: int = 1) -> np.ndarray:
        """Trace ``samples`` samples/pixel, return resolved HDR (H, W, 3).

        ``view`` is a CameraView (camera.py) or its pytree. Size comes from
        the camera's pixel_count set at get_view time — pass explicitly via
        self.resize for raw pytrees."""
        self.render_frame_async(view, status, samples)
        return self.finish_frame()

    def render_frame_async(self, view,
                           status: RenderStatus = RenderStatus.RESET,
                           samples: int = 1) -> None:
        """Dispatch ``samples`` samples without waiting for the device.

        The host-async overlap analog of the reference's thread pool
        (system.cpp:438-458 overlaps animation/TLAS updates with device
        work; CUDART/Context.cpp renders on a private stream): XLA's
        async dispatch returns as soon as the work is enqueued, so the
        caller can run host work — animation evaluation, the next
        frame's skinning/refit, IO — while the chip traces. Call
        ``finish_frame()`` to block and read the frame back. On the
        multi-chunk compacted driver the overlap is partial (its
        inter-depth live-count readbacks sync); single-chunk interactive
        frames (the case that matters for overlap) are fully async."""
        from ..camera import CameraView
        if isinstance(view, CameraView):
            raise TypeError("pass Camera.get_view().as_pytree() plus "
                            "resize(), or use RenderSystem.render_frame")
        # a second dispatch would silently clobber the in-flight frame's
        # pending (probe, stats, aux) tuple — finish_frame() first
        if self._pending is not None:
            raise RuntimeError("render_frame_async while a frame is in "
                               "flight; call finish_frame() first")
        width, height = self._size
        assert width > 0, "call resize(w, h) first"
        self.update()
        step = self._get_trace_fn(width, height)

        if status == RenderStatus.RESET or self._accumulator is None or \
                self._accumulator.shape[0] != width * height:
            self._accumulator = jnp.zeros((width * height, 3), jnp.float32)
            self._sample_count = 0

        probe_index = (self._probe_xy[1] * width + self._probe_xy[0])
        timer = Timer()
        probe = None
        stats = None
        aux = None
        drv = getattr(self, "_driver", None)
        mstep = getattr(self, "_multi_step", None)
        if mstep is not None and samples > 1:
            # single-chunk fused path: all samples in ONE dispatch
            out = mstep(self._scene, self._accumulator, view,
                        jnp.uint32(self._sample_count),
                        jnp.int32(probe_index), n_samples=samples)
            self._accumulator, probe, stats, aux = out
            self._sample_count += samples
            self._pending = (probe, stats, aux, timer, samples)
            return
        if drv is not None and not self.config.profile_stages:
            # multi-chunk driver path: whole CONVERGE request in ONE
            # dispatch (traced sample count — one compiled program for
            # every count, INCLUDING samples=1: fori_loop(0, 1) over the
            # same body equals the single-sample step exactly, so
            # interactive 1-spp frames reuse the warmed batch program
            # instead of compiling a second program set); with
            # profile_stages the host loop below keeps the
            # per-depth-synced last sample instead
            out = drv.step_multi(self._scene, self._accumulator, view,
                                 self._sample_count, probe_index, samples)
            self._accumulator, probe, stats, aux = out
            self._sample_count += samples
            self._pending = (probe, stats, aux, timer, samples)
            return
        for s in range(samples):
            step_s = step
            if (drv is not None and samples > 1 and s == samples - 1
                    and self.config.profile_stages):
                # last sample of a multi-sample frame runs the host-loop
                # PROFILED step: its per-depth syncs fill the per-stage
                # RenderStats times (context.h:50-72 parity) at 1/samples
                # of the sync cost; frames agree to float ulps (same
                # stage/compaction functions, different jit graphs).
                # OPT-IN (config.profile_stages): the profiled step is a
                # SECOND full set of jit programs to compile
                step_s = drv.step_profiled
            out = step_s(
                self._scene, self._accumulator,
                view, jnp.uint32(self._sample_count),
                jnp.int32(probe_index))
            if len(out) == 4:
                self._accumulator, probe, stats, aux = out
            else:
                self._accumulator, probe, stats = out
            self._sample_count += 1
        self._pending = (probe, stats, aux, timer, samples)

    def finish_frame(self) -> np.ndarray:
        """Block on the dispatched frame, fill stats, return resolved HDR."""
        assert self._pending is not None, "no render_frame_async in flight"
        probe, stats, aux, timer, samples = self._pending
        self._pending = None
        width, height = self._size
        self._accumulator.block_until_ready()
        elapsed = timer.elapsed()

        # stats (RenderStats protocol) — ONE batched device→host transfer
        # (int()/np.asarray per value costs a device sync each)
        if stats is not None:
            keys = sorted(stats)
            vec = [jnp.asarray(stats[k], jnp.float32) for k in keys]
            if probe is not None:
                vec.append(jnp.asarray(probe, jnp.float32))
            flat = np.asarray(jnp.concatenate(
                [jnp.atleast_1d(v) for v in vec]))
            s = {k: int(flat[i]) for i, k in enumerate(keys)}
            if probe is not None:
                probe = flat[len(keys):len(keys) + 3]
            self.stats.primary_count = s.get("ray_count_0", 0)
            self.stats.secondary_count = s.get("ray_count_1", 0)
            self.stats.deep_count = sum(
                v for k, v in s.items()
                if k.startswith("ray_count_") and int(k.split("_")[-1]) >= 2)
            self.stats.shadow_count = sum(
                v for k, v in s.items() if k.startswith("shadow_count_"))
            self.stats.render_time = elapsed
            nan_ct = sum(v for k, v in s.items()
                         if k.startswith("nan_scrubbed"))
            if nan_ct:   # debug_checks sanitizer (SURVEY §5): loud, not
                from ..utils import logger   # silent zeroing
                logger.warning("debug_checks: %d NaN contributions "
                               "scrubbed this frame", nan_ct)
        # per-depth stage times (context.h:50-72 parity): the compacted
        # driver syncs between depths (live-count readback), so the split
        # is measured, not estimated
        drv = getattr(self, "_driver", None)
        if drv is not None and drv.depth_times:
            # measured by the profiled step's per-depth syncs (the last
            # sample of a multi-sample frame)
            dt = drv.depth_times
            self.stats.primary_time = dt[0]
            self.stats.secondary_time = dt[1] if len(dt) > 1 else 0.0
            self.stats.deep_time = sum(dt[2:]) if len(dt) > 2 else 0.0
        if probe is not None:
            p = np.asarray(probe)
            self._probe_result = (int(p[0]), int(p[1]), float(p[2]))

        frame = resolve_accumulator(self._accumulator, self._sample_count)
        frame = frame.reshape(height, width, 3)
        if self._denoise and aux is not None:
            from ..ops.denoise import denoise
            if drv is not None:
                # driver aux stays in lane order per sample; invert once
                # per frame here (the only consumer)
                aux = drv.aux_inverse(aux)
            frame = denoise(frame,
                            aux["normal"].reshape(height, width, 3),
                            aux["depth"].reshape(height, width))
        return np.asarray(frame)

    # -- progressive-render checkpoint (SURVEY §5: the reference's
    # accumulator+sampleIndex is resumable in-session only,
    # CUDART/Context.cpp:75-80; persisting them makes long renders
    # resumable across processes, like camera.bin does for the camera) --

    def get_render_state(self):
        """(accumulator (N,3) np.float32, sample_count) or None."""
        if self._accumulator is None:
            return None
        return np.asarray(self._accumulator), int(self._sample_count)

    def set_render_state(self, accumulator, sample_count: int) -> None:
        acc = np.asarray(accumulator, np.float32)
        w, h = self._size
        assert acc.shape == (w * h, 3), (
            f"accumulator {acc.shape} does not match {w}x{h}")
        self._accumulator = jnp.asarray(acc)
        self._sample_count = int(sample_count)

    def resize(self, width: int, height: int) -> None:
        if (width, height) != self._size:
            self._size = (width, height)
            self._trace_fn = None
            self._accumulator = None

    def get_probe_results(self):
        return self._probe_result

    def validate(self) -> None:
        """Scene invariants: finite geometry, material ids in range, BVH
        children contained (validate() ABI; the analog of the reference's
        asserts at system.cpp:99-105,308-312)."""
        self.update()
        s = self._scene
        verts = np.asarray(s["tri_vertices"])
        if not np.isfinite(verts).all():
            raise ValueError("non-finite triangle vertices")
        n_mat = np.asarray(s["materials"]["color"]).shape[0]
        mats = np.asarray(s["tri_material"])
        if mats.min() < 0 or mats.max() >= n_mat:
            raise ValueError(
                f"material id out of range: [{mats.min()}, {mats.max()}] "
                f"vs {n_mat} materials")
        bvh = s["bvh"]
        child = np.asarray(bvh["child"])
        count = np.asarray(bvh["count"])
        n_tri = verts.shape[0]
        leaf = count > 0
        if leaf.any():
            firsts = child[leaf]
            if firsts.min() < 0 or (firsts + count[leaf]).max() > n_tri:
                raise ValueError("BVH leaf range out of bounds")
        internal = (count < 0) & (child >= 0)
        if internal.any() and child[internal].max() >= child.shape[0]:
            raise ValueError("BVH child index out of bounds")

    # -- settings ------------------------------------------------------------

    def get_available_settings(self):
        return [
            RenderSetting("intersector", self._intersector_name,
                          sorted(FACTORIES)),
            # the OptiX backend's "DENOISE" setting analog
            # (OptiXContext.cpp:812-822)
            RenderSetting("denoise", "1" if self._denoise else "0",
                          ["0", "1"]),
        ]

    def set_setting(self, name: str, value: str) -> None:
        super().set_setting(name, value)
        if name == "intersector":
            if value not in FACTORIES:
                raise ValueError(f"unknown intersector {value!r}")
            if value != self._intersector_name:
                # transforms-only fast updates leave the flat BVH/treelet
                # arrays stale (only the TLAS tables track moves) — force
                # a full rebuild when the intersector changes
                self._geo_key = None
                self._dirty = True
            if value == "tlas" and not self.config.use_tlas:
                # the two-level tables ride the device scene only when
                # use_tlas is set — selecting the intersector through the
                # runtime-settings protocol implies it (else the trace
                # would KeyError on scene["tlas"]). _anim_key must be
                # nulled TOO: a config flip needs a FULL rebuild to add
                # the new tables, and the refit shortcut (which keys on
                # _anim_key, not _geo_key) would otherwise refresh the
                # old table-less scene
                object.__setattr__(self.config, "use_tlas", True)
                self._geo_key = None
                self._anim_key = None
                self._dirty = True
            self._intersector_name = value
            self._trace_fn = None
        elif name == "denoise":
            self._denoise = value in ("1", "true", "True")


@register_engine("bruteforce")
class BruteForceEngine(PathTracerEngine):
    """Exact reference tracer — the oracle (tiny scenes only)."""

    default_intersector = "brute"


@register_engine("megakernel")
class MegakernelEngine(PathTracerEngine):
    """BVH path tracer, runs everywhere (CPURT analog)."""

    default_intersector = "bvh"


# The wavefront engine's intersector on each JAX platform. The GPU entry
# is set by the on-card A/B of the wavefront engine at 1080p on the seeded
# interior (PERF.md); the CPU runs the plain BVH walk.
GPU_INTERSECTOR = "visit"


def default_intersector(platform: str) -> str:
    if platform == "gpu":
        return GPU_INTERSECTOR
    if platform == "cpu":
        return "bvh"
    raise RuntimeError(f"no wavefront intersector for platform {platform!r}")


@register_engine("wavefront")
class WavefrontEngine(PathTracerEngine):
    """Flagship engine: per-depth compacted wavefront driver over the
    platform's default intersector (``default_intersector``); the runtime
    ``intersector`` setting still chooses any other."""

    use_wavefront_driver = True

    def __init__(self, config: RenderConfig | None = None):
        super().__init__(config)
        self._intersector_name = default_intersector(jax.default_backend())


@register_engine("direct")
class DirectEngine(PathTracerEngine):
    """Primary + NEE shadow rays only (EmbreeRT/CPURT behavior:
    direct lighting, no bounces, no accumulation past spp)."""

    default_intersector = "bvh"

    def _integrator_config(self) -> RenderConfig:
        return dataclasses.replace(self.config, max_path_length=0,
                                   russian_roulette=False)
