"""Multi-chip tiled rendering: shard_map over image row-blocks.

The rebuild's answer to SURVEY §2.9's "multi-GPU: absent": each chip traces
a contiguous row block of the pixel domain (scene + BVH replicated — MBs),
then the framebuffer is assembled with an all-gather and per-stage ray
counters are reduced with psum (XLA hands both to NCCL on GPUs). This is
BASELINE config 5 (Sponza-class 1080p tiled across several cards).

Everything here is shape-polymorphic in the device count, and runs on the
CPU with ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` for tests —
the driver's dryrun_multichip uses exactly that path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from .mesh import TILE_AXIS, make_tile_mesh
from ..render.integrator import Intersector, trace_sample


def make_tiled_renderer(mesh, width: int, height: int,
                        config: RenderConfig, intersector: Intersector,
                        gather: bool = True):
    """Build a jitted multi-chip render step.

    Returns step(scene, accumulator, view, sample_index) → (accumulator',
    stats) where accumulator is (W*H, 3) sharded by rows across ``mesh``.
    With ``gather=True`` the returned accumulator is all-gathered
    (replicated) so the host reads one framebuffer; gather=False keeps it
    row-sharded for pipelined accumulation (gather once at the end).
    """
    n_dev = mesh.shape[TILE_AXIS]
    n_total = width * height
    assert n_total % n_dev == 0, (
        f"pixel count {n_total} must divide by {n_dev} devices")
    n_local = n_total // n_dev

    def tile_fn(scene, accumulator, view, sample_index):
        # scene/view replicated; accumulator row-sharded
        tile = jax.lax.axis_index(TILE_AXIS)
        offset = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        radiance, _probe, stats, _aux = trace_sample(
            scene, view, width, height, sample_index,
            jnp.int32(0), config, intersector,
            pixel_offset=offset, n_pixels=n_local)
        acc = accumulator + radiance
        stats = {k: jax.lax.psum(v, TILE_AXIS) for k, v in stats.items()}
        if gather:
            acc_out = jax.lax.all_gather(acc, TILE_AXIS, axis=0, tiled=True)
        else:
            acc_out = acc
        return acc_out, stats

    out_acc_spec = P() if gather else P(TILE_AXIS)
    fn = shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P(), P()),
        out_specs=(out_acc_spec, P()),
        check_vma=False,
    )
    return jax.jit(fn)


def make_engine_step(mesh, width: int, height: int, config: RenderConfig,
                     intersector: Intersector, tex_flags=None):
    """Multi-chip step with the ENGINE step contract — the product-ABI
    route: ``RenderConfig.n_devices > 1`` makes
    PathTracerEngine.render_frame call this instead of the single-chip
    driver, so ``RenderSystem(..., config)`` is all a user touches.

    step(scene, accumulator, view, sample_index, probe_index) →
    (accumulator', probe, stats, aux): accumulator and aux are
    replicated row-major full-frame arrays; each chip traces its own
    contiguous row block; stats are psum-reduced and the probe is
    contributed by the owning tile only.
    """
    n_dev = mesh.shape[TILE_AXIS]
    n_total = width * height
    assert n_total % n_dev == 0, (
        f"pixel count {n_total} must divide by {n_dev} devices")
    n_local = n_total // n_dev

    def tile_fn(scene, accumulator, view, sample_index, probe_index):
        tile = jax.lax.axis_index(TILE_AXIS)
        offset = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        rel = probe_index - offset.astype(jnp.int32)
        owner = (rel >= 0) & (rel < n_local)
        radiance, probe, stats, aux = trace_sample(
            scene, view, width, height, sample_index,
            jnp.clip(rel, 0, n_local - 1), config, intersector,
            pixel_offset=offset, n_pixels=n_local, tex_flags=tex_flags)
        acc_rows = jax.lax.dynamic_slice(
            accumulator, (offset.astype(jnp.int32), 0), (n_local, 3))
        acc_rows = acc_rows + radiance
        acc_out = jax.lax.all_gather(acc_rows, TILE_AXIS, axis=0,
                                     tiled=True)
        aux_out = jax.tree.map(
            lambda a: jax.lax.all_gather(a, TILE_AXIS, axis=0, tiled=True),
            aux)
        stats = {k: jax.lax.psum(v, TILE_AXIS) for k, v in stats.items()}
        probe = jax.lax.psum(jnp.where(owner, probe, 0.0), TILE_AXIS)
        return acc_out, probe, stats, aux_out

    fn = shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    jfn = jax.jit(fn)

    def step(scene, accumulator, view, sample_index, probe_index):
        return jfn(scene, accumulator, view,
                   jnp.asarray(sample_index, jnp.uint32),
                   jnp.asarray(probe_index, jnp.int32))

    return step


def make_driver_engine_step(mesh, width: int, height: int,
                            config: RenderConfig,
                            intersector: Intersector, tex_flags=None,
                            chunk: int | None = None):
    """Multi-chip step running the FLAGSHIP compacted wavefront program
    per chip (the fused ``make_engine_step`` left
    BASELINE config 5 on the slow single-dispatch path). Each tile runs
    ``wavefront_driver.make_sample_body`` on its contiguous row block:
    per-depth lane compaction, traced live-count chunk trips, zero host
    syncs — then one all-gather assembles the frame and psum reduces
    the per-depth stats. RNG is absolute-pixel-id keyed and the sample
    body restores row-major order per tile, so tiled == single-device
    per pixel (tests/test_parallel.py)."""
    import numpy as np

    from ..render.integrator import _tile_permutation
    from ..render.wavefront_driver import make_sample_body

    n_dev = mesh.shape[TILE_AXIS]
    n_total = width * height
    assert n_total % n_dev == 0, (
        f"pixel count {n_total} must divide by {n_dev} devices")
    n_local = n_total // n_dev
    if chunk is None:
        chunk = n_local
        n_chunks = max(1, -(-n_local // config.max_rays_per_pass))
        while n_local % n_chunks:
            n_chunks += 1
        chunk = n_local // n_chunks
    body = make_sample_body(width, height, n_local, chunk, config,
                            intersector, tex_flags)
    tp = _tile_permutation(width, n_local)
    if tp is not None:
        perm_np, inv_np = tp
        pid_base = jnp.asarray(perm_np.astype(np.uint32))
        inv_base = jnp.asarray(inv_np)
    else:
        pid_base = jnp.arange(n_local, dtype=jnp.uint32)
        inv_base = None

    def tile_fn(scene, accumulator, view, sample_index, probe_index):
        tile = jax.lax.axis_index(TILE_AXIS)
        offset = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        rel = probe_index - offset.astype(jnp.int32)
        owner = (rel >= 0) & (rel < n_local)
        rel_c = jnp.clip(rel, 0, n_local - 1)
        probe_lane = inv_base[rel_c] if inv_base is not None else rel_c
        acc_rows = jax.lax.dynamic_slice(
            accumulator, (offset.astype(jnp.int32), 0), (n_local, 3))
        acc_rows, probe, stats, aux = body(
            scene, acc_rows, pid_base + offset, inv_base, view,
            sample_index, jnp.where(owner, probe_lane, 0))
        acc_out = jax.lax.all_gather(acc_rows, TILE_AXIS, axis=0,
                                     tiled=True)
        aux_out = jax.tree.map(
            lambda a: jax.lax.all_gather(a, TILE_AXIS, axis=0, tiled=True),
            aux)
        stats = {k: jax.lax.psum(v, TILE_AXIS) for k, v in stats.items()}
        probe = jax.lax.psum(jnp.where(owner, probe, 0.0), TILE_AXIS)
        return acc_out, probe, stats, aux_out

    fn = shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    # donate the accumulator like the single-chip driver — without it
    # every sample keeps input+output framebuffers alive per device
    jfn = jax.jit(fn, donate_argnums=(1,))

    def step(scene, accumulator, view, sample_index, probe_index):
        return jfn(scene, accumulator, view,
                   jnp.asarray(sample_index, jnp.uint32),
                   jnp.asarray(probe_index, jnp.int32))

    return step


def render_tiled(scene, view, width: int, height: int,
                 config: RenderConfig, intersector: Intersector,
                 samples: int = 1, mesh=None):
    """Convenience wrapper: allocate, run ``samples`` steps, resolve.

    Accumulates with a row-sharded accumulator and gathers once at the end
    (one ICI all-gather per frame, not per sample)."""
    mesh = mesh or make_tile_mesh()
    n_dev = mesh.shape[TILE_AXIS]
    n_total = width * height
    step = make_tiled_renderer(mesh, width, height, config, intersector,
                               gather=False)
    from .mesh import row_sharded
    acc = jax.device_put(jnp.zeros((n_total, 3), jnp.float32),
                         row_sharded(mesh))
    stats = None
    for s in range(samples):
        acc, stats = step(scene, acc, view, jnp.uint32(s))
    # final assembly over ICI
    gather_fn = jax.jit(shard_map(
        lambda a: jax.lax.all_gather(a, TILE_AXIS, axis=0, tiled=True),
        mesh=mesh, in_specs=P(TILE_AXIS), out_specs=P(),
        check_vma=False))
    frame = gather_fn(acc) / jnp.float32(max(samples, 1))
    return frame.reshape(height, width, 3), stats
