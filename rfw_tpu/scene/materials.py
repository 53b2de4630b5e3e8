"""Material system: host materials, dedup texture cache, device SoA packing.

Reimplements HostMaterial / material_list
(/root/reference/RFW/system/src/rfw/material_list.h:18-122, material_list.cpp):
Disney-principled parameters + texture slots, emissive = any(color > 1)
(material_list.h:76). Instead of the reference's 128-byte fixed-point packed
``Material`` (structs.h:85-161), the device representation is a dict of SoA
float32/int32 planes — gather-friendly and lossless (no 0.8 fixed point
quantization needed).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import logger

# Texture slot indices (reference map[11], material_list.h:18-27 MapProps;
# device sampling getShadingData.h:148-206: diffuse layers 2/3 ADD to the
# base texel, normal layers 2/3 add tangent-space vectors pre-normalize).
# Slots 0-4 keep their round-1 indices; 5-10 complete the 11-slot surface.
TEX_DIFFUSE = 0
TEX_NORMAL = 1
TEX_SPECULARITY = 2
TEX_ROUGHNESS = 3
TEX_ALPHA = 4
TEX_DIFFUSE1 = 5       # 2nd diffuse layer (additive, Has2ndDiffuseMap)
TEX_DIFFUSE2 = 6       # 3rd diffuse layer
TEX_NORMAL1 = 7        # 2nd normal layer (additive pre-normalize)
TEX_NORMAL2 = 8        # 3rd normal layer
TEX_ROUGHNESS1 = 9     # 2nd roughness map (host-side parity; unsampled
#                        on device — the reference's kernels don't read it)
TEX_COLORMASK = 10     # color mask (host-side parity, as above)
NUM_TEX_SLOTS = 11


@dataclasses.dataclass
class MapProps:
    """One texture binding (reference material_list.h:21-27)."""

    texture_id: int = -1
    value_scale: float = 1.0
    uv_scale: tuple[float, float] = (1.0, 1.0)
    uv_offset: tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class HostMaterial:
    """Editable host material (reference material_list.h:18-77)."""

    name: str = "unnamed"
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    absorption: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 0.5
    roughness: float = 0.5
    specular_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.0
    eta: float = 1.0
    flags: int = 0
    alpha_cutout: bool = False   # HasAlpha: diffuse-map alpha < 0.5 discards
    #                              (reference MatPropFlags HasAlpha)
    maps: list[MapProps] = dataclasses.field(
        default_factory=lambda: [MapProps() for _ in range(NUM_TEX_SLOTS)])

    def is_emissive(self) -> bool:
        """Emissive iff any radiance channel exceeds 1 (material_list.h:76)."""
        return bool(np.any(np.asarray(self.color) > 1.0))


# Parameter plane names in packing order; shading code indexes by name.
_SCALAR_PARAMS = (
    "metallic", "subsurface", "specular", "roughness", "specular_tint",
    "anisotropic", "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
    "transmission", "eta",
)


class MaterialList:
    """Materials of record + dedup texture registry (material_list.cpp)."""

    def __init__(self) -> None:
        self._materials: list[HostMaterial] = []
        self._textures: list = []           # scene.texture.Texture
        self._tex_cache: dict[str, int] = {}  # path → texture id (dedup,
        #                                      material_list.cpp:272-316)
        self._dirty = True

    # -- materials -----------------------------------------------------------

    def add(self, mat: HostMaterial) -> int:
        self._materials.append(mat)
        self._dirty = True
        return len(self._materials) - 1

    def set(self, index: int, mat: HostMaterial) -> None:
        self._materials[index] = mat
        self._dirty = True

    def get(self, index: int) -> HostMaterial:
        return self._materials[index]

    @property
    def materials(self) -> list[HostMaterial]:
        return self._materials

    def __len__(self) -> int:
        return len(self._materials)

    @property
    def is_dirty(self) -> bool:
        return self._dirty

    def mark_clean(self) -> None:
        self._dirty = False

    def mark_dirty(self) -> None:
        self._dirty = True

    # -- textures ------------------------------------------------------------

    def add_texture_from_file(self, path: str) -> int:
        """Load + cache a texture by path (material_list.cpp:272-316)."""
        key = str(path)
        if key in self._tex_cache:
            return self._tex_cache[key]
        from .texture import Texture
        try:
            tex = Texture.load(path)
        except Exception as e:  # missing texture → no binding, warn like ref
            logger.warning("failed to load texture %s: %s", path, e)
            return -1
        tid = self.add_texture(tex)
        self._tex_cache[key] = tid
        return tid

    def add_texture(self, tex) -> int:
        self._textures.append(tex)
        self._dirty = True
        return len(self._textures) - 1

    @property
    def textures(self) -> list:
        return self._textures

    # -- device packing ------------------------------------------------------

    def generate_device_materials(self) -> dict[str, np.ndarray]:
        """Pack host materials into SoA planes (cf. convertToDeviceMaterial,
        material_list.cpp:318-340 — minus the fixed-point quantization).

        Texture bindings are (atlas_addr, width, height, uv transform) per
        slot; -1 addr means unbound. Atlas addresses are filled in by
        ``build_texture_atlas`` (texture.py) before rendering.
        """
        n = max(len(self._materials), 1)
        mats = self._materials or [HostMaterial()]
        out: dict[str, np.ndarray] = {
            "color": np.stack([np.asarray(m.color, np.float32) for m in mats]),
            "absorption": np.stack(
                [np.asarray(m.absorption, np.float32) for m in mats]),
            "flags": np.array([m.flags for m in mats], np.int32),
        }
        for p in _SCALAR_PARAMS:
            out[p] = np.array([getattr(m, p) for m in mats], np.float32)
        for slot in range(NUM_TEX_SLOTS):
            out[f"tex{slot}_id"] = np.array(
                [m.maps[slot].texture_id for m in mats], np.int32)
            out[f"tex{slot}_uvtransform"] = np.stack([
                np.array([*m.maps[slot].uv_scale, *m.maps[slot].uv_offset],
                         np.float32) for m in mats])
        out["emissive"] = np.array(
            [m.is_emissive() for m in mats], np.bool_)
        out["alpha_cutout"] = np.array(
            [getattr(m, "alpha_cutout", False) for m in mats], np.bool_)
        assert out["color"].shape == (n, 3)
        return out
