"""Hit → ShadingData derivation: attribute interpolation, texturing, frames.

jnp port of ``getShadingData`` (/root/reference/RFW/backends/CUDART/src/
getShadingData.h:100-160) and its trilinear atlas fetch (:60-98): gathers
per-triangle attributes, interpolates by barycentrics, samples the flat
texture atlas with mip selection from the ray-cone LOD (lambda = tri LOD +
log2(coneWidth / |cos|), eq. 26 of the texture LOD paper the reference
cites), applies normal maps, and assembles the BSDF parameter dict.

Barycentric convention: (u, v) from the intersector weight vertices 1 and 2;
w = 1-u-v weights vertex 0 (standard Möller–Trumbore).
"""

from __future__ import annotations

import jax.numpy as jnp

from .bsdf.common import dot3, safe_normalize

_MIN_ROUGHNESS_PARAM = 0.001  # compat.h getRoughness clamp


def create_tangent_space(n):
    """Branchless orthonormal frame from a normal (createTangentSpace
    analog; Frisvad/Duff construction)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                   -sign * n[..., 0]], axis=-1)
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                   axis=-1)
    return t, bt


# ---------------------------------------------------------------------------
# Texture atlas sampling
# ---------------------------------------------------------------------------

def fetch_texel_bilinear(atlas, addr, width, height, uv):
    """Bilinear fetch with repeat wrap from the flat (N, 4) atlas.

    addr/width/height: (R,) int32 per-ray mip descriptor; uv: (R, 2).
    """
    w = width.astype(jnp.float32)
    h = height.astype(jnp.float32)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), jnp.maximum(n, 1))

    x0i, x1i = wrap(x0, width), wrap(x0 + 1, width)
    y0i, y1i = wrap(y0, height), wrap(y0 + 1, height)
    p00 = atlas[addr + y0i * width + x0i]
    p10 = atlas[addr + y0i * width + x1i]
    p01 = atlas[addr + y1i * width + x0i]
    p11 = atlas[addr + y1i * width + x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    return ((1 - fy) * ((1 - fx) * p00 + fx * p10)
            + fy * ((1 - fx) * p01 + fx * p11))


def fetch_texel_nearest(atlas, addr, width, height, uv):
    """Point sample with repeat wrap (1 tap)."""
    x = (uv[..., 0] * width.astype(jnp.float32)).astype(jnp.int32)
    y = (uv[..., 1] * height.astype(jnp.float32)).astype(jnp.int32)
    x = jnp.mod(x, jnp.maximum(width, 1))
    y = jnp.mod(y, jnp.maximum(height, 1))
    return atlas[addr + y * width + x]


def fetch_texel_trilinear(atlas, desc, tex_id, uv, lam,
                          filter: str = "trilinear"):
    """FetchTexelTrilinear (getShadingData.h:60-98): blend two mip levels.

    desc: (T, L, 3) int32 (addr, width, height); tex_id: (R,) (assumed
    valid — callers mask unbound slots); lam: (R,) LOD lambda.

    ``filter`` degrades quality for tap count (each tap is one gather —
    config.texture_filter): "trilinear" 8 taps,
    "bilinear" 4 taps at the nearest mip, "nearest" 1 tap.
    """
    levels = desc.shape[1]
    lam = jnp.clip(lam, 0.0, levels - 1)
    if filter == "trilinear":
        l0 = jnp.floor(lam).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, levels - 1)
        f = (lam - l0.astype(jnp.float32))[..., None]
        d0 = desc[tex_id, l0]
        d1 = desc[tex_id, l1]
        p0 = fetch_texel_bilinear(atlas, d0[..., 0], d0[..., 1],
                                  d0[..., 2], uv)
        p1 = fetch_texel_bilinear(atlas, d1[..., 0], d1[..., 1],
                                  d1[..., 2], uv)
        return (1.0 - f) * p0 + f * p1
    if filter == "stochastic":
        raise ValueError("stochastic filter needs a seed — use "
                         "fetch_texel_stochastic")
    l0 = jnp.round(lam).astype(jnp.int32)
    d0 = desc[tex_id, l0]
    if filter == "bilinear":
        return fetch_texel_bilinear(atlas, d0[..., 0], d0[..., 1],
                                    d0[..., 2], uv)
    return fetch_texel_nearest(atlas, d0[..., 0], d0[..., 1],
                               d0[..., 2], uv)


def fetch_texel_stochastic(atlas, desc, tex_id, uv, lam, seed):
    """ONE-tap stochastic trilinear: choose the mip with probability equal
    to the trilinear blend weight and the bilinear corner with
    probabilities (fx, fy) — the expectation is exactly the 8-tap
    trilinear filter, for 1/8 the gathers. The added
    noise is texture-frequency, averages out across spp like any MC
    estimator, and is far below path-tracing noise at low spp.

    ``seed``: (R,) uint32 stream (consumed: 3 draws). Returns (texel,
    new_seed).
    """
    from . import rng as rng_mod
    levels = desc.shape[1]
    lam = jnp.clip(lam, 0.0, levels - 1)
    l0 = jnp.floor(lam).astype(jnp.int32)
    f = lam - l0.astype(jnp.float32)
    seed, (r_mip, r_x, r_y) = rng_mod.random_floats(seed, 3)
    lev = jnp.where(r_mip < f, jnp.minimum(l0 + 1, levels - 1), l0)
    d = desc[tex_id, lev]
    addr, width, height = d[..., 0], d[..., 1], d[..., 2]
    x = uv[..., 0] * width.astype(jnp.float32) - 0.5
    y = uv[..., 1] * height.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    xi = jnp.where(r_x < x - x0, x0 + 1, x0)
    yi = jnp.where(r_y < y - y0, y0 + 1, y0)
    xi = jnp.mod(xi.astype(jnp.int32), jnp.maximum(width, 1))
    yi = jnp.mod(yi.astype(jnp.int32), jnp.maximum(height, 1))
    return atlas[addr + yi * width + xi], seed


def _unpack_rgba8(word):
    """(R,) u32 RGBA8 → (R, 4) f32 in [0, 1] (r in bits 0-7)."""
    return jnp.stack(
        [word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
         (word >> 24) & 0xFF], axis=-1).astype(jnp.float32) * (1.0 / 255.0)


def fetch_merged_stochastic(matlas, desc, eid, uv, lam, seed):
    """ONE texel gather serving diffuse + normal + rough at once: the
    merged-atlas row (texture.build_merged_material_atlas) fetched with
    the stochastic-trilinear estimator (fetch_texel_stochastic) — mip and
    bilinear corner chosen with probability equal to their filter weight,
    so the expectation is exactly fetch_merged_trilinear's 8-tap result.
    One gather serves all three maps. Returns ((diffuse, normal, rough)
    each (R, 4) f32, new_seed)."""
    from . import rng as rng_mod
    levels = desc.shape[1]
    lam = jnp.clip(lam, 0.0, levels - 1)
    l0 = jnp.floor(lam).astype(jnp.int32)
    f = lam - l0.astype(jnp.float32)
    seed, (r_mip, r_x, r_y) = rng_mod.random_floats(seed, 3)
    lev = jnp.where(r_mip < f, jnp.minimum(l0 + 1, levels - 1), l0)
    d = desc[eid, lev]
    addr, width, height = d[..., 0], d[..., 1], d[..., 2]
    x = uv[..., 0] * width.astype(jnp.float32) - 0.5
    y = uv[..., 1] * height.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    xi = jnp.where(r_x < x - x0, x0 + 1, x0)
    yi = jnp.where(r_y < y - y0, y0 + 1, y0)
    xi = jnp.mod(xi.astype(jnp.int32), jnp.maximum(width, 1))
    yi = jnp.mod(yi.astype(jnp.int32), jnp.maximum(height, 1))
    px = matlas[addr + yi * width + xi]                    # (R, 3) u32
    return (_unpack_rgba8(px[:, 0]), _unpack_rgba8(px[:, 1]),
            _unpack_rgba8(px[:, 2])), seed


def fetch_merged_trilinear(matlas, desc, eid, uv, lam):
    """Trilinear fetch from the merged material atlas (texture.py
    build_merged_material_atlas): ONE tap per corner serves the diffuse,
    normal and roughness maps at once — 8 row gathers instead of 24.

    matlas: (N, 3) u32 rows (word0 diffuse, word1 normal, word2 rough/metal).
    Returns (diffuse (R,4), normal (R,4), rough (R,4)) f32 in [0,1].
    """
    levels = desc.shape[1]
    lam = jnp.clip(lam, 0.0, levels - 1)
    l0 = jnp.floor(lam).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    lf = lam - l0.astype(jnp.float32)
    acc = [0.0, 0.0, 0.0]
    for lvl, lw in ((l0, 1.0 - lf), (l1, lf)):
        d = desc[eid, lvl]
        addr, width, height = d[..., 0], d[..., 1], d[..., 2]
        x = uv[..., 0] * width.astype(jnp.float32) - 0.5
        y = uv[..., 1] * height.astype(jnp.float32) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        fy = y - y0

        def wrap(i, n):
            return jnp.mod(i.astype(jnp.int32), jnp.maximum(n, 1))

        x0i, x1i = wrap(x0, width), wrap(x0 + 1, width)
        y0i, y1i = wrap(y0, height), wrap(y0 + 1, height)
        for xi, yi, cw in ((x0i, y0i, (1 - fx) * (1 - fy)),
                           (x1i, y0i, fx * (1 - fy)),
                           (x0i, y1i, (1 - fx) * fy),
                           (x1i, y1i, fx * fy)):
            px = matlas[addr + yi * width + xi]        # (R, 3) u32
            w = (lw * cw)[..., None]
            for c in range(3):
                acc[c] = acc[c] + w * _unpack_rgba8(px[:, c])
    return acc[0], acc[1], acc[2]


# ---------------------------------------------------------------------------
# ShadingData assembly
# ---------------------------------------------------------------------------

_PARAM_KEYS = ("metallic", "subsurface", "specular", "roughness",
               "specular_tint", "anisotropic", "sheen", "sheen_tint",
               "clearcoat", "clearcoat_gloss", "transmission", "eta")


def get_shading_data(scene, prim, u, v, d, cone_width, tex_flags=None,
                     tex_filter: str = "trilinear", stoch_seed=None):
    """Derive shading state for hit rays.

    scene: device scene dict (render/scene_data.py) with triangle SoA planes
    in *permuted* order, material planes, and texture atlas. prim: (R,)
    permuted triangle index (callers pass a valid index; misses are masked
    by the engine). ``stoch_seed``: (R,) uint32 stream, required for
    tex_filter == "stochastic" (one unbiased tap per map instead of 8).
    Returns (sd, n_geom, i_n, t_vec, b_vec, alpha_cut).
    """
    if tex_filter == "stochastic" and stoch_seed is None:
        tex_filter = "bilinear"     # no randomness available: fall back

    def _fetch(atlas, desc, tid, uvq, lamq, salt):
        nonlocal stoch_seed
        if tex_filter == "stochastic":
            texel, stoch_seed = fetch_texel_stochastic(
                atlas, desc, tid, uvq, lamq, stoch_seed ^ jnp.uint32(salt))
            return texel
        return fetch_texel_trilinear(atlas, desc, tid, uvq, lamq,
                                     filter=tex_filter)

    prim = jnp.maximum(prim, 0)
    pk = scene.get("tri_pack")
    if pk is not None:
        # ONE (R, 32) row gather for every per-triangle attribute
        # (scene_data.build_tri_pack)
        row = pk[prim]
        tri_n = row[:, 0:9].reshape(-1, 3, 3)
        tri_uv = row[:, 9:15].reshape(-1, 3, 2)
        n_geom = row[:, 15:18]
        tangent_pk = row[:, 18:21]
        bitangent_pk = row[:, 21:24]
        mat_id = row[:, 24].astype(jnp.int32)
        lod_base = row[:, 25]
    else:
        tri_n = scene["tri_normals"][prim]       # (R, 3, 3)
        tri_uv = scene["tri_uv"][prim]           # (R, 3, 2)
        n_geom = scene["tri_gnormal"][prim]      # (R, 3)
        mat_id = scene["tri_material"][prim]     # (R,)
        lod_base = scene["tri_lod"][prim]
        tangent_pk = bitangent_pk = None

    w = (1.0 - u - v)[..., None]
    i_n = safe_normalize(w * tri_n[:, 0] + u[..., None] * tri_n[:, 1]
                         + v[..., None] * tri_n[:, 2])
    uv_i = w * tri_uv[:, 0] + u[..., None] * tri_uv[:, 1] \
        + v[..., None] * tri_uv[:, 2]

    mats = scene["materials"]
    # Pack ALL per-material parameters into one (M, 28) matrix in-jit
    # (concat of tiny tables — free) and fetch with ONE row gather
    # instead of ~18 separate (R,) gathers (the tri_pack layout applied
    # to materials).
    f32 = jnp.float32
    cols = [mats["color"], mats["absorption"],
            mats["flags"].astype(f32)[:, None]]
    cols += [mats[k].astype(f32)[:, None] for k in _PARAM_KEYS]
    cols += [mats["tex0_id"].astype(f32)[:, None],
             mats["tex1_id"].astype(f32)[:, None],
             mats["tex3_id"].astype(f32)[:, None],
             mats["tex0_uvtransform"],
             mats["alpha_cutout"].astype(f32)[:, None]]
    if "mtex_id" in mats:
        cols.append(mats["mtex_id"].astype(f32)[:, None])
    # additive texture layers (reference getShadingData.h:162-206):
    # columns appended only when the scene binds them (tex_flags), so
    # the common single-layer case pays nothing
    tf0 = tex_flags or {}
    want_dlay = bool(tf0.get("diffuse_layers")) and "tex5_id" in mats
    want_nlay = bool(tf0.get("normal_layers")) and "tex7_id" in mats
    lay_base = sum(c.shape[1] for c in cols)
    if want_dlay:
        cols += [mats["tex5_id"].astype(f32)[:, None],
                 mats["tex6_id"].astype(f32)[:, None],
                 mats["tex5_uvtransform"], mats["tex6_uvtransform"]]
    if want_nlay:
        cols += [mats["tex7_id"].astype(f32)[:, None],
                 mats["tex8_id"].astype(f32)[:, None],
                 mats["tex7_uvtransform"], mats["tex8_uvtransform"]]
    mrow = jnp.concatenate(cols, axis=1)[mat_id]          # (R, 27/28)
    sd = {
        "color": mrow[:, 0:3],
        "absorption": mrow[:, 3:6],
        "flags": mrow[:, 6].astype(jnp.int32),
    }
    for i, k in enumerate(_PARAM_KEYS):
        sd[k] = mrow[:, 7 + i]
    npar = 7 + len(_PARAM_KEYS)
    m_tex0 = mrow[:, npar].astype(jnp.int32)
    m_tex1 = mrow[:, npar + 1].astype(jnp.int32)
    m_tex3 = mrow[:, npar + 2].astype(jnp.int32)
    m_uvt = mrow[:, npar + 3:npar + 7]
    m_alpha = mrow[:, npar + 7] > 0.5
    m_mtex = (mrow[:, npar + 8].astype(jnp.int32)
              if "mtex_id" in mats else None)
    nlay_base = lay_base
    if want_dlay:
        m_tex5 = mrow[:, lay_base].astype(jnp.int32)
        m_tex6 = mrow[:, lay_base + 1].astype(jnp.int32)
        m_uvt5 = mrow[:, lay_base + 2:lay_base + 6]
        m_uvt6 = mrow[:, lay_base + 6:lay_base + 10]
        nlay_base = lay_base + 10
    if want_nlay:
        m_tex7 = mrow[:, nlay_base].astype(jnp.int32)
        m_tex8 = mrow[:, nlay_base + 1].astype(jnp.int32)
        m_uvt7 = mrow[:, nlay_base + 2:nlay_base + 6]
        m_uvt8 = mrow[:, nlay_base + 6:nlay_base + 10]
    sd["roughness"] = jnp.maximum(sd["roughness"], _MIN_ROUGHNESS_PARAM)

    alpha_cut = jnp.zeros_like(u, dtype=bool)

    tf = tex_flags or {"diffuse": True, "normal": True, "rough": True}
    # m_mtex guard: without the per-material merged-entry table a None
    # eid would silently index as jnp.newaxis (shape bug, not a miss)
    if (scene.get("matlas") is not None and any(tf.values())
            and m_mtex is not None):
        # merged-atlas fast path: one trilinear fetch for all three maps
        matlas = scene["matlas"]
        desc = scene["matlas_desc"]
        eid = m_mtex
        tex0 = m_tex0
        has_tex0 = tex0 >= 0
        uvt = m_uvt
        uv0 = uvt[..., 0:2] * (uvt[..., 2:4] + uv_i)
        base_w = desc[eid, 0, 1].astype(jnp.float32)
        lam = (jnp.log2(jnp.maximum(
            base_w * cone_width
            / jnp.maximum(jnp.abs(dot3(-d, n_geom)), 1e-4), 1e-20))
            - lod_base)
        if tex_filter == "stochastic" and stoch_seed is not None:
            (texel, nm, mr), stoch_seed = fetch_merged_stochastic(
                matlas, desc, eid, uv0, lam,
                stoch_seed ^ jnp.uint32(0x2545F491))
        else:
            texel, nm, mr = fetch_merged_trilinear(matlas, desc, eid,
                                                   uv0, lam)
        if tf["diffuse"]:
            sd["color"] = jnp.where(has_tex0[..., None],
                                    sd["color"] * texel[..., :3],
                                    sd["color"])
            alpha_cut = (has_tex0 & (texel[..., 3] < 0.5)
                         & m_alpha)
        if tf["rough"]:
            has_r = m_tex3 >= 0
            sd["roughness"] = jnp.where(
                has_r, jnp.maximum(sd["roughness"] * mr[..., 1],
                                   _MIN_ROUGHNESS_PARAM), sd["roughness"])
            sd["metallic"] = jnp.where(has_r, sd["metallic"] * mr[..., 2],
                                       sd["metallic"])
        if tf["normal"]:
            has_n = m_tex1 >= 0
            tangent = tangent_pk if tangent_pk is not None \
                else scene["tri_tangent"][prim]
            bitangent = bitangent_pk if bitangent_pk is not None \
                else scene["tri_bitangent"][prim]
            nm_vec = nm[..., :3] * 2.0 - 1.0
            mapped = safe_normalize(
                nm_vec[..., 0:1] * tangent + nm_vec[..., 1:2] * bitangent
                + nm_vec[..., 2:3] * i_n)
            i_n = jnp.where(has_n[..., None], mapped, i_n)
    elif "atlas" in scene and scene["atlas"] is not None:
        atlas = scene["atlas"]
        desc = scene["atlas_desc"]
        # diffuse map (slot 0)
        tex0 = m_tex0
        lam = jnp.zeros_like(u)
        has_tex0 = tex0 >= 0
        if tf["diffuse"]:
            uvt = m_uvt
            uv0 = uvt[..., 0:2] * (uvt[..., 2:4] + uv_i)
            base_w = desc[jnp.maximum(tex0, 0), 0, 1].astype(jnp.float32)
            lam = (jnp.log2(jnp.maximum(
                base_w * cone_width
                / jnp.maximum(jnp.abs(dot3(-d, n_geom)), 1e-4), 1e-20))
                - lod_base)
            texel = _fetch(atlas, desc, jnp.maximum(tex0, 0), uv0, lam,
                           0x68E31DA4)
            sd["color"] = jnp.where(has_tex0[..., None],
                                    sd["color"] * texel[..., :3],
                                    sd["color"])
            alpha_cut = (has_tex0 & (texel[..., 3] < 0.5)
                         & m_alpha)
            if want_dlay:
                # 2nd/3rd diffuse layers ADD to the modulated base
                # (getShadingData.h:162-176; the reference then
                # multiplies by the base texel a second time at :214 —
                # a double-modulation slip not reproduced here)
                for tid_l, uvt_l, salt in ((m_tex5, m_uvt5, 0x41C64E6D),
                                           (m_tex6, m_uvt6, 0x6C078965)):
                    has_l = tid_l >= 0
                    uvl = uvt_l[..., 0:2] * (uvt_l[..., 2:4] + uv_i)
                    texl = _fetch(atlas, desc, jnp.maximum(tid_l, 0),
                                  uvl, lam, salt)
                    sd["color"] = jnp.where(
                        (has_tex0 & has_l)[..., None],
                        sd["color"] + texl[..., :3], sd["color"])

        if tf["rough"]:
            # roughness map (slot 3): glTF metallicRoughness (G=rough,
            # B=metal)
            tex_r = m_tex3
            has_r = tex_r >= 0
            mr = _fetch(atlas, desc, jnp.maximum(tex_r, 0), uv_i, lam,
                        0xB5297A4D)
            sd["roughness"] = jnp.where(
                has_r, jnp.maximum(sd["roughness"] * mr[..., 1],
                                   _MIN_ROUGHNESS_PARAM), sd["roughness"])
            sd["metallic"] = jnp.where(has_r, sd["metallic"] * mr[..., 2],
                                       sd["metallic"])

        if tf["normal"]:
            # normal map (slot 1): tangent-space, UV-aligned frame
            tex_n = m_tex1
            has_n = tex_n >= 0
            nm = _fetch(atlas, desc, jnp.maximum(tex_n, 0), uv_i, lam,
                        0x1B56C4E9)
            tangent = tangent_pk if tangent_pk is not None \
                else scene["tri_tangent"][prim]
            bitangent = bitangent_pk if bitangent_pk is not None \
                else scene["tri_bitangent"][prim]
            nm_vec = nm[..., :3] * 2.0 - 1.0
            if want_nlay:
                # 2nd/3rd normal layers add tangent-space vectors before
                # the normalize (getShadingData.h:185-203; the reference
                # samples layer 1's address for layer 2 — a copy-paste
                # slip not reproduced: each layer reads its own slot)
                for tid_l, uvt_l, salt in ((m_tex7, m_uvt7, 0x9908B0DF),
                                           (m_tex8, m_uvt8, 0x3243F6A8)):
                    has_l = tid_l >= 0
                    uvl = uvt_l[..., 0:2] * (uvt_l[..., 2:4] + uv_i)
                    nml = _fetch(atlas, desc, jnp.maximum(tid_l, 0),
                                 uvl, lam, salt)
                    nm_vec = jnp.where(
                        (has_n & has_l)[..., None],
                        nm_vec + (nml[..., :3] * 2.0 - 1.0), nm_vec)
            mapped = safe_normalize(
                nm_vec[..., 0:1] * tangent + nm_vec[..., 1:2] * bitangent
                + nm_vec[..., 2:3] * i_n)
            i_n = jnp.where(has_n[..., None], mapped, i_n)

    t_vec, b_vec = create_tangent_space(i_n)
    return sd, n_geom, i_n, t_vec, b_vec, alpha_cut
