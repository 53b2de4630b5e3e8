"""RenderSystem — the scene of record (L4).

Python rebuild of ``rfw::system`` (/root/reference/RFW/system/src/rfw/
system.{h,cpp}): owns models, instances, materials, lights, skybox and the
camera file; tracks mutations in a dirty bitset (system.h:160-169) and pushes
minimal updates to the engine in ``synchronize()`` (system.cpp:247-433);
extracts area lights from emissive triangles (system.cpp:967-1032); exposes
probe picking (system.cpp:876-893) and the add_object/add_quad/add_instance
surface (system.cpp:499-620).
"""

from __future__ import annotations

import os
import enum
from typing import Sequence

import numpy as np

from .camera import Camera
from .config import RenderConfig
from .refs import GeometryRef, InstanceRef, LightRef
from .render.context import EngineContext, RenderStatus, create_engine
from .scene import (AreaLight, DirectionalLight, HostMaterial, MaterialList,
                    PointLight, SceneMesh, Skybox, SpotLight, load_object,
                    make_quad)
from .scene.lights import pack_lights
from .scene.object import SceneObject
from .utils import logger


class Changed(enum.IntFlag):
    """Dirty bitset (system.h:160-169)."""

    NONE = 0
    MODELS = 1
    INSTANCES = 2
    MATERIALS = 4
    LIGHTS = 8
    AREA_LIGHTS = 16
    SKYBOX = 32
    ANIMATED = 64
    TEXTURES = 128


class RenderSystem:
    def __init__(self, engine: str | EngineContext = "megakernel",
                 config: RenderConfig | None = None):
        self.config = config or RenderConfig()
        if isinstance(engine, str):
            try:
                self._context = create_engine(engine, self.config)
            except Exception as e:  # fall back like app.cpp:61-71
                logger.warning("engine %r failed (%s); falling back to "
                               "megakernel", engine, e)
                self._context = create_engine("megakernel", self.config)
        else:
            self._context = engine
        self.camera = Camera()
        self._materials = MaterialList()
        self._objects: list[SceneObject] = []
        self._instances: list[InstanceRef | None] = []
        self._instance_matrices: list[np.ndarray] = []
        self._point_lights: list[PointLight] = []
        self._spot_lights: list[SpotLight] = []
        self._dir_lights: list[DirectionalLight] = []
        self._area_lights: list[AreaLight] = []
        self._skybox: Skybox | None = None
        self._changed = Changed.NONE
        self._mesh_slots = 0
        self._should_reset = True
        self._animation_time = 0.0

    # -- engine --------------------------------------------------------------

    @property
    def context(self) -> EngineContext:
        return self._context

    def set_context(self, engine: str | EngineContext) -> None:
        """Swap the render backend at runtime (load_render_api analog)."""
        if isinstance(engine, str):
            engine = create_engine(engine, self.config)
        self._context = engine
        self._changed = (Changed.MODELS | Changed.INSTANCES
                         | Changed.MATERIALS | Changed.LIGHTS
                         | Changed.AREA_LIGHTS | Changed.SKYBOX
                         | Changed.TEXTURES)

    # -- scene building (system.cpp:499-620) ---------------------------------

    def request_mesh_slot(self) -> int:
        slot = self._mesh_slots
        self._mesh_slots += 1
        return slot

    def add_object(self, path: str, material_override: int = -1,
                   normalize: bool = False) -> GeometryRef:
        """Load a model (system.cpp:499-554). ``normalize`` rescales and
        recenters it into a unit box at the origin (the reference's
        normalize flag)."""
        obj = load_object(path, self._materials, material_override)
        if normalize:
            lo = np.min([m.positions.min(0) for m in obj.meshes], axis=0)
            hi = np.max([m.positions.max(0) for m in obj.meshes], axis=0)
            center = 0.5 * (lo + hi)
            scale = 1.0 / max(float((hi - lo).max()), 1e-20)
            for m in obj.meshes:
                m.positions = ((m.positions - center) * scale).astype(
                    np.float32)
                if m.base_positions is not None:
                    m.base_positions = ((m.base_positions - center)
                                        * scale).astype(np.float32)
                m.invalidate()
        for mesh in obj.meshes:
            mesh.mesh_slot = self.request_mesh_slot()
        self._objects.append(obj)
        self._changed |= Changed.MODELS | Changed.MATERIALS | Changed.TEXTURES
        emissive = np.array([m.is_emissive()
                             for m in self._materials.materials], bool)
        obj.compute_light_indices(emissive)
        if any(len(li) for li in obj.light_indices):
            self._changed |= Changed.AREA_LIGHTS | Changed.LIGHTS
        return GeometryRef(len(self._objects) - 1, self)

    def add_quad(self, normal, position, width: float, height: float,
                 material_id: int) -> GeometryRef:
        return self.add_mesh(
            make_quad(normal, position, width, height, material_id), "quad")

    def add_mesh(self, mesh: SceneMesh, name: str = "mesh") -> GeometryRef:
        """Add an in-memory mesh as a one-mesh object (material ids index
        this system's material list)."""
        mesh.mesh_slot = self.request_mesh_slot()
        obj = SceneObject(name=name)
        obj.meshes.append(mesh)
        obj.finalize()
        self._objects.append(obj)
        self._changed |= Changed.MODELS | Changed.MATERIALS
        emissive = np.array([m.is_emissive()
                             for m in self._materials.materials], bool)
        obj.compute_light_indices(emissive)
        if any(len(li) for li in obj.light_indices):
            self._changed |= Changed.AREA_LIGHTS | Changed.LIGHTS
        return GeometryRef(len(self._objects) - 1, self)

    def add_instance(self, geometry: GeometryRef,
                     scale=(1, 1, 1), translation=(0, 0, 0),
                     rotation_deg: float = 0.0, rotation_axis=(0, 1, 0)
                     ) -> InstanceRef:
        ref = InstanceRef(len(self._instances), geometry, self)
        self._instances.append(ref)
        self._instance_matrices.append(np.eye(4, dtype=np.float32))
        ref.set_transform(scale=scale, translation=translation,
                          rotation_deg=rotation_deg,
                          rotation_axis=rotation_axis)
        if any(len(li) for li in geometry.object.light_indices):
            self._changed |= Changed.AREA_LIGHTS | Changed.LIGHTS
        return ref

    def update_instance(self, index: int, matrix: np.ndarray) -> None:
        self._instance_matrices[index] = np.asarray(matrix, np.float32)
        self._changed |= Changed.INSTANCES
        obj = self._instances[index].geometry.object
        if any(len(li) for li in obj.light_indices):
            self._changed |= Changed.AREA_LIGHTS

    # -- materials (system.cpp add_material / get_material) ------------------

    def add_material(self, color, roughness: float = 1.0, **kw) -> int:
        mat = HostMaterial(color=np.asarray(color, np.float32),
                           roughness=roughness, **kw)
        self._changed |= Changed.MATERIALS
        return self._materials.add(mat)

    def get_material(self, index: int) -> HostMaterial:
        return self._materials.get(index)

    def set_material(self, index: int, mat: HostMaterial) -> None:
        self._materials.set(index, mat)
        self._changed |= Changed.MATERIALS

    @property
    def materials(self) -> MaterialList:
        return self._materials

    # -- lights (system.cpp:720-766) -----------------------------------------

    def add_point_light(self, position, radiance) -> LightRef:
        self._point_lights.append(PointLight(
            np.asarray(position, np.float32),
            np.asarray(radiance, np.float32)))
        self._changed |= Changed.LIGHTS
        return LightRef(len(self._point_lights) - 1, "point", self)

    def add_spot_light(self, position, cos_inner, radiance, cos_outer,
                       direction) -> LightRef:
        self._spot_lights.append(SpotLight(
            np.asarray(position, np.float32),
            np.asarray(direction, np.float32),
            np.asarray(radiance, np.float32),
            float(cos_inner), float(cos_outer)))
        self._changed |= Changed.LIGHTS
        return LightRef(len(self._spot_lights) - 1, "spot", self)

    def add_directional_light(self, direction, radiance) -> LightRef:
        d = np.asarray(direction, np.float64)
        self._dir_lights.append(DirectionalLight(
            (d / np.linalg.norm(d)).astype(np.float32),
            np.asarray(radiance, np.float32)))
        self._changed |= Changed.LIGHTS
        return LightRef(len(self._dir_lights) - 1, "directional", self)

    # -- skybox (system.cpp set_skybox) --------------------------------------

    def set_skybox(self, source) -> None:
        if isinstance(source, Skybox):
            self._skybox = source
        elif isinstance(source, str):
            self._skybox = Skybox.load(source)
        else:
            self._skybox = Skybox(np.asarray(source, np.float32))
        self._changed |= Changed.SKYBOX

    # -- animation (system.cpp:435-471) --------------------------------------

    def set_animations_to(self, t: float) -> None:
        if not self.config.animation_enabled:
            return
        self._animation_time = t
        changed = False
        for obj in self._objects:
            if obj.is_animated and obj.set_time(t):
                changed = True
        if changed:
            self._changed |= Changed.ANIMATED
            if self._area_lights:
                self._changed |= Changed.AREA_LIGHTS

    # -- area lights (system.cpp:967-1032) -----------------------------------

    def _update_area_lights(self) -> dict:
        self._area_lights = []
        overrides: dict[tuple[int, int], int] = {}
        for inst_idx, inst in enumerate(self._instances):
            if inst is None:
                continue
            obj = inst.geometry.object
            matrix = self._instance_matrices[inst_idx]
            for mesh_i, mesh in enumerate(obj.meshes):
                if mesh_i >= len(obj.light_indices):
                    continue
                light_tris = obj.light_indices[mesh_i]
                if not len(light_tris):
                    continue
                transform = matrix @ obj.mesh_matrices[mesh_i]
                r = transform[:3, :3]
                nmat = (np.linalg.inv(r).T
                        if abs(np.linalg.det(r)) > 1e-12 else r)
                tris = mesh.triangles()
                for tri_idx in light_tris:
                    v = tris.vertices[tri_idx] @ r.T + transform[:3, 3]
                    n = tris.gnormal[tri_idx] @ nmat.T
                    n = n / max(np.linalg.norm(n), 1e-20)
                    mat = self._materials.get(int(tris.material[tri_idx]))
                    area = 0.5 * np.linalg.norm(
                        np.cross(v[1] - v[0], v[2] - v[0]))
                    li = len(self._area_lights)
                    self._area_lights.append(AreaLight(
                        vertex0=v[0], vertex1=v[1], vertex2=v[2],
                        normal=n.astype(np.float32),
                        radiance=np.asarray(mat.color, np.float32),
                        area=float(area), tri_idx=int(tri_idx),
                        inst_idx=inst_idx, mesh_idx=mesh_i))
                    overrides[(inst_idx, int(tri_idx))] = li
        return overrides

    # -- synchronize (system.cpp:247-433) ------------------------------------

    def synchronize(self) -> None:
        ctx = self._context
        changed = self._changed
        if changed == Changed.NONE:
            return

        if changed & Changed.SKYBOX and self._skybox is not None:
            ctx.set_sky(self._skybox.pixels)

        if changed & (Changed.MATERIALS | Changed.TEXTURES) or \
                self._materials.is_dirty:
            mats_dev = self._materials.generate_device_materials()
            from .scene.texture import build_atlases_cached
            atlas, mtex_id = build_atlases_cached(
                self._materials.materials, self._materials.textures,
                self.config.merged_material_atlas)
            if self.config.merged_material_atlas:
                if mtex_id is None:
                    mtex_id = np.zeros(
                        max(len(self._materials.materials), 1), np.int32)
                mats_dev["mtex_id"] = mtex_id
            ctx.set_materials(mats_dev)
            ctx.set_textures(atlas)
            self._materials.mark_clean()
            # emissive set may have changed → recompute light indices
            emissive = np.array([m.is_emissive()
                                 for m in self._materials.materials], bool)
            for obj in self._objects:
                obj.compute_light_indices(emissive)
            changed |= Changed.AREA_LIGHTS

        # model/animation updates → push per-mesh triangle SoA
        if changed & (Changed.MODELS | Changed.ANIMATED):
            for obj in self._objects:
                for mesh in obj.meshes:
                    ctx.set_mesh(mesh.mesh_slot, mesh.triangles())

        # instances (explicit, or implicit identity for instanced-less usage)
        if changed & (Changed.INSTANCES | Changed.MODELS | Changed.ANIMATED):
            inst_id = 0
            for idx, inst in enumerate(self._instances):
                if inst is None:
                    continue
                obj = inst.geometry.object
                for mesh_i, mesh in enumerate(obj.meshes):
                    ctx.set_instance(
                        inst_id, mesh.mesh_slot,
                        self._instance_matrices[idx]
                        @ obj.mesh_matrices[mesh_i])
                    inst_id += 1

        if changed & Changed.AREA_LIGHTS:
            self._update_area_lights()

        if changed & (Changed.LIGHTS | Changed.AREA_LIGHTS):
            # engine-facing overrides use *flattened* (instance, mesh) ids —
            # the same numbering set_instance used above
            flat_id: dict[tuple[int, int], int] = {}
            inst_id = 0
            for idx, inst in enumerate(self._instances):
                if inst is None:
                    continue
                for mesh_i in range(len(inst.geometry.object.meshes)):
                    flat_id[(idx, mesh_i)] = inst_id
                    inst_id += 1
            flat_overrides = {
                (flat_id.get((al.inst_idx, al.mesh_idx), -1), al.tri_idx): li
                for li, al in enumerate(self._area_lights)
            }
            ctx.set_lights(pack_lights(
                self._area_lights, self._point_lights, self._spot_lights,
                self._dir_lights), overrides=flat_overrides)

        ctx.update()
        self._changed = Changed.NONE
        self._should_reset = True

    # -- frame (system.cpp:682-718) ------------------------------------------

    def render_frame(self, camera: Camera | None = None,
                     status: RenderStatus | None = None,
                     samples: int = 1) -> np.ndarray:
        cam = camera or self.camera
        self.synchronize()
        if status is None:
            status = (RenderStatus.RESET if self._should_reset
                      else RenderStatus.CONVERGE)
        w, h = cam.pixel_count
        self._context.resize(w, h)
        frame = self._context.render_frame(cam.get_view().as_pytree(),
                                           status, samples=samples)
        self._should_reset = False
        return frame

    def render_frame_async(self, camera: Camera | None = None,
                           status: RenderStatus | None = None,
                           samples: int = 1) -> None:
        """Dispatch a frame without waiting (host-async overlap: run
        animation/IO for the NEXT frame while the chip traces this one,
        then ``finish_frame()``). The reference gets this overlap from
        its thread pool (system.cpp:438-458); here XLA async dispatch
        provides it thread-free."""
        cam = camera or self.camera
        self.synchronize()
        if status is None:
            status = (RenderStatus.RESET if self._should_reset
                      else RenderStatus.CONVERGE)
        w, h = cam.pixel_count
        self._context.resize(w, h)
        self._context.render_frame_async(cam.get_view().as_pytree(),
                                         status, samples=samples)
        self._should_reset = False

    def finish_frame(self) -> np.ndarray:
        """Block on the in-flight async frame and return it."""
        return self._context.finish_frame()

    def render_tonemapped(self, camera: Camera | None = None,
                          status: RenderStatus | None = None,
                          samples: int = 1,
                          fxaa: bool = False) -> np.ndarray:
        """render_frame + the ACES pass (system.cpp:694-714).
        ``fxaa`` additionally runs the app harness's FXAA post blit
        (reference app.h:23-61) over the tonemapped frame."""
        cam = camera or self.camera
        hdr = self.render_frame(cam, status, samples)
        return self.tonemap_frame(hdr, cam.brightness, cam.contrast,
                                  fxaa=fxaa)

    def tonemap_frame(self, hdr: np.ndarray,
                      brightness: float | None = None,
                      contrast: float | None = None,
                      fxaa: bool = False) -> np.ndarray:
        """The ACES pass alone, for frames obtained via the async ABI
        (``render_frame_async`` + ``finish_frame``). ``brightness`` /
        ``contrast`` default to the current camera's — pass values
        captured at dispatch time when host code may mutate the camera
        while the frame is in flight (App.run's pipelined loop)."""
        import jax.numpy as jnp

        from .ops import tonemap
        if brightness is None:
            brightness = self.camera.brightness
        if contrast is None:
            contrast = self.camera.contrast
        ldr = tonemap.tonemap(jnp.asarray(hdr), brightness, contrast)
        if fxaa:
            ldr = tonemap.fxaa(ldr)
        return np.asarray(ldr)

    # -- progressive-render checkpoint ---------------------------------------

    def save_render_state(self, path: str) -> bool:
        """Persist the progressive accumulator + sample count (+ camera)
        so a long render can resume across processes — the reference
        keeps them in-session only (RenderStatus::Converge continues,
        CUDART/Context.cpp:75-80); camera.bin-style persistence applied
        to the framebuffer. Returns False when nothing was rendered."""
        state = self._context.get_render_state()
        if state is None:
            return False
        acc, spp = state
        # the ENGINE owns the accumulator shape — the camera may have
        # been resized since the last render
        w, h = getattr(self._context, "_size", self.camera.pixel_count)
        if acc.shape[0] != w * h:
            return False
        if not path.endswith(".npz"):
            path += ".npz"      # np.savez appends it silently otherwise
        np.savez(path, accumulator=acc, sample_count=spp,
                 width=w, height=h,
                 camera=self.camera.serialize_bytes())
        return True

    def load_render_state(self, path: str) -> bool:
        """Restore a saved render state; continue with
        ``render_frame(status=RenderStatus.CONVERGE)``. Returns False
        (untouched state) when the file is absent or mismatched."""
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"      # match save_render_state's normalization
        try:
            z = np.load(path, allow_pickle=False)
            w, h = int(z["width"]), int(z["height"])
            acc = np.asarray(z["accumulator"], np.float32)
            spp = int(z["sample_count"])
        except Exception:       # corrupt/truncated zip raises BadZipFile;
            return False        # the contract is False on ANY bad file
        if acc.shape != (w * h, 3):
            return False
        if "camera" in z.files:
            self.camera = Camera.deserialize_bytes(bytes(z["camera"]))
        self.camera.resize(w, h)
        self._context.resize(w, h)
        # flush any pending scene upload FIRST — the engine's update()
        # restarts accumulation ("scene changed ⇒ restart"), which would
        # clobber the restored sample count on the next render
        self.synchronize()
        if hasattr(self._context, "update"):
            self._context.update()
        self._context.set_render_state(acc, spp)
        self._should_reset = False
        return True

    # -- probe (system.cpp:876-893) ------------------------------------------

    def set_probe_index(self, pixel_xy: tuple[int, int]) -> None:
        self._context.set_probe_index(pixel_xy)

    def get_probe_results(self):
        return self._context.get_probe_results()

    # -- runtime settings (context.h:36-48 enumerable protocol) --------------

    def get_available_settings(self):
        return self._context.get_available_settings()

    def set_setting(self, name: str, value: str) -> None:
        self._context.set_setting(name, value)

    # -- stats ---------------------------------------------------------------

    def get_render_stats(self):
        return self._context.get_stats()

    @property
    def area_lights(self) -> Sequence[AreaLight]:
        return self._area_lights
