"""Per-block exact visit-list intersector: a Pallas kernel through Triton.

The candidate unit is the per-256-ray-BLOCK **exact union** of crossed
cells (K-triangle treelets of the spatial cut, ``bvh/wide.py``):

1. **Enumerate (XLA)**: per ray block, the entry lower bound of every
   cell any of its rays crosses — an (N, T) slab test reduced over the
   block's rays as a running (NB, T) minimum, so the (N, T) product never
   reaches device memory.
2. **Order (XLA)**: per block, candidates sort by packed
   (quantized-entry, cell id) keys — one (NB, T) row sort per launch.
3. **Kernel (Pallas/Triton)**: one program per RB-ray quarter of a
   block walks the block's visit list front to back; per visit it loads
   one cell's Woop planes (plain loads — the whole table fits the L2),
   intersects its RB rays with the cell's K triangles in KC-wide register
   chunks, and keeps a per-ray running minimum (t, slot). It exits once
   every ray's best hit precedes the next cell's entry lower bound
   (closest) or every live ray is occluded (any-hit). Results come out in
   ray order.
4. **Recull passes (driver)**: blocks whose union overflows the visit
   cap continue from the next window of the one-shot candidate table, so
   the result is exact without full scans.

The triangle test is the Woop unit-triangle transform as exact-f32 FMAs
(no matrix unit: TF32 would flip closest-hit winners); the winner is
refined with Möller–Trumbore in ``closest_hit``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import RenderConfig
from .intersect import BIG_T, intersect_tri

BLOCK = 256        # rays per visit block (one shared visit list)
M_C = 128          # visit-list window (cells per block per pass)
RB = 64            # rays per kernel program: a quarter of a block
KC = 32            # triangles per in-register chunk of a cell
NUM_WARPS = 4
# recull passes run to the exact per-launch bound ceil(T_padded / M_C)
# (all windows of the one-shot candidate table): a constant cap would
# silently treat rays in blocks whose visit list outruns cap*M_C cells as
# misses. The while_loop still exits as soon as every ray is finished.
_BIGKEY = np.float32(1 << 25)   # np: no backend init at import


def _cid_bits(t_c: int) -> int:
    return max((t_c - 1).bit_length(), 1)


# ---------------------------------------------------------------------------
# Phase 1: per-block entry bounds (XLA)
# ---------------------------------------------------------------------------

ENUM_RAYS = 8      # rays per step of the enumeration loop


@jax.jit
def block_entries(rays8, bounds8):
    """rays8 (NB*8, BLOCK) → (NB, T) per-block entry lower bounds: the
    least slab-entry distance over the block's rays that cross each cell
    (1e30 where none does).

    A loop over the block's rays, ENUM_RAYS per step, keeps a running
    (NB, T) minimum: each step is one elementwise fusion. (The same
    minimum written as one (NB, BLOCK, T) reduction took XLA's GPU
    compiler over half an hour to compile.)"""
    nb = rays8.shape[0] // 8
    r = rays8.reshape(nb, 8, BLOCK)
    bl, bh = bounds8[0:3][:, None, :], bounds8[3:6][:, None, :]  # (3,1,T)

    def step(k, best):
        rs = jax.lax.dynamic_slice_in_dim(r, k * ENUM_RAYS, ENUM_RAYS,
                                          axis=2)       # (NB, 8, ENUM)
        for j in range(ENUM_RAYS):
            o = rs[:, 0:3, j].T[:, :, None]             # (3, NB, 1)
            d = rs[:, 4:7, j].T[:, :, None]
            inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                                  jnp.where(d < 0, -1e-12, 1e-12), d)
            t1 = (bl - o) * inv                         # (3, NB, T)
            t2 = (bh - o) * inv
            ent = jnp.maximum(jnp.max(jnp.minimum(t1, t2), axis=0), 0.0)
            ext = jnp.min(jnp.maximum(t1, t2), axis=0)
            crossed = ent < jnp.minimum(ext, rs[:, 3, j][:, None])
            best = jnp.minimum(best, jnp.where(crossed, ent, 1e30))
        return best

    init = jnp.full((nb, bounds8.shape[1]), 1e30, jnp.float32)
    return jax.lax.fori_loop(0, BLOCK // ENUM_RAYS, step, init)


@jax.jit
def block_entries_envelope(rays8, bounds8):
    """Per-BLOCK interval-envelope entry bounds: (NB, T) like
    ``block_entries`` but from NB×T slab tests instead of N×T — ~BLOCK×
    fewer ops. Conservative: envelope-crossed ⊇ any-ray-crossed and the
    entry value is a lower bound for every ray in the block, so
    front-to-back exit and recull watermarks stay exact; only the visit
    lists grow. Use for COHERENT streams (primary tiles, converging
    shadow rays) — scattered blocks degrade to near-full scans."""
    nb = rays8.shape[0] // 8
    r = rays8.reshape(nb, 8, BLOCK)
    o = r[:, 0:3]                                  # (NB, 3, g)
    tm = r[:, 3]                                   # (NB, g)
    d = r[:, 4:7]
    t_hi = tm.max(axis=1)[:, None]                 # (NB, 1)
    o_lo, o_hi = o.min(axis=2), o.max(axis=2)      # (NB, 3)
    safe = jnp.where(jnp.abs(d) < 1e-12,
                     jnp.where(d < 0, -1e-12, 1e-12), d)
    inv = 1.0 / safe
    inv_lo, inv_hi = inv.min(axis=2), inv.max(axis=2)
    ent = jnp.zeros((nb, bounds8.shape[1]), jnp.float32)
    ext = jnp.full((nb, bounds8.shape[1]), 3e38, jnp.float32)
    for ax in range(3):
        b_lo = bounds8[ax][None, :]                # (1, T)
        b_hi = bounds8[3 + ax][None, :]
        il = inv_lo[:, ax:ax + 1]
        ih = inv_hi[:, ax:ax + 1]
        lo1, hi1 = _imul(b_lo - o_hi[:, ax:ax + 1],
                         b_lo - o_lo[:, ax:ax + 1], il, ih)
        lo2, hi2 = _imul(b_hi - o_hi[:, ax:ax + 1],
                         b_hi - o_lo[:, ax:ax + 1], il, ih)
        ent = jnp.maximum(ent, jnp.minimum(lo1, lo2))
        ext = jnp.minimum(ext, jnp.maximum(hi1, hi2))
    crossed = ent < jnp.minimum(ext, t_hi)
    return jnp.where(crossed, ent, 1e30)


def _imul(a_lo, a_hi, b_lo, b_hi):
    """Interval product endpoints: [a_lo,a_hi]×[b_lo,b_hi]."""
    p1, p2 = a_lo * b_lo, a_lo * b_hi
    p3, p4 = a_hi * b_lo, a_hi * b_hi
    return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
            jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))


# ---------------------------------------------------------------------------
# Phase 2: entry-ordered visit lists (XLA — small row sort)
# ---------------------------------------------------------------------------

def sort_candidates(b_entry, diag, m_c: int):
    """(NB, T) entries → (keys_all, counts_all): the FULL entry-sorted
    packed-key table, computed ONCE per launch.

    Cell keys are geometric — an entry value depends only on the ray
    block's origins/directions, never on the per-pass horizons (a
    tightened ``t_hi`` only *removes* cells from the crossed set) — so
    the pass-0 table is a superset ordering that stays valid for every
    recull pass: pass ``it`` consumes the window ``[it*m_c, (it+1)*m_c)``
    (see ``window_candidates``). Visiting a cell the tightened horizon
    would have pruned is harmless (the kernel's front-to-back exit skips
    it); *skipping* one never happens, which is what makes windowed
    continuation exact.

    Keys pack the quantized entry with the cell id into exact-int f32
    (< 2^24) — unique per cell. The table is padded to a multiple of
    ``m_c`` with invalid keys so window slices never clamp into valid
    entries."""
    t_c = b_entry.shape[1]
    cb = _cid_bits(t_c)
    qmax = (1 << (24 - cb)) - 1
    q = jnp.minimum(jnp.floor(b_entry * (qmax / diag)), jnp.float32(qmax))
    q = jnp.maximum(q, 0.0)
    cid = jnp.arange(t_c, dtype=jnp.float32)[None]
    key = q * (1 << cb) + cid
    key = jnp.where(b_entry < BIG_T, key, _BIGKEY)
    keys_all = jax.lax.sort(key, dimension=-1)
    counts_all = jnp.sum(key < _BIGKEY, axis=-1).astype(jnp.int32)
    pad = (-t_c) % m_c
    if pad:
        keys_all = jnp.pad(keys_all, ((0, 0), (0, pad)),
                           constant_values=float(_BIGKEY))
    return keys_all, counts_all


def window_candidates(keys_all, counts_all, it, diag, m_c: int, t_c: int):
    """Pass ``it``'s visit window: (ids, counts, tnears, next_tnear).
    ``next_tnear`` is the entry lower bound of each block's FIRST cell
    beyond this window (BIG_T when exhausted) — a ray whose best hit
    precedes it cannot be beaten by any later pass."""
    cb = _cid_bits(t_c)
    qmax = (1 << (24 - cb)) - 1
    gran = diag / qmax
    t_pad = keys_all.shape[1]
    start = jnp.minimum(it * m_c, t_pad - m_c)
    keys = jax.lax.dynamic_slice_in_dim(keys_all, start, m_c, axis=1)
    counts = jnp.clip(counts_all - it * m_c, 0, m_c)
    ids = jnp.where(keys < _BIGKEY,
                    keys.astype(jnp.int32) & ((1 << cb) - 1), t_c)
    tnears = jnp.where(keys < _BIGKEY,
                       jnp.floor(keys / (1 << cb)) * gran, BIG_T)
    nxt = jax.lax.dynamic_slice_in_dim(
        keys_all, jnp.minimum((it + 1) * m_c, t_pad - 1), 1, axis=1)[:, 0]
    next_tnear = jnp.where(nxt < _BIGKEY,
                           jnp.floor(nxt / (1 << cb)) * gran, BIG_T)
    return ids, counts, tnears, next_tnear


# ---------------------------------------------------------------------------
# Phase 3: the visit kernel
# ---------------------------------------------------------------------------

def _visit_kernel(super_g: int, k_size: int, k_pad: int, kc: int, m_c: int,
                  t_epsilon: float, any_hit: bool,
                  ids_ref,        # (1, M_C) this block's visit list
                  counts_ref,     # (1, 1)
                  tnears_ref,     # (1, M_C) entry lower bound per visit
                  rays_ref,       # (8, RB) ox,oy,oz,tmax,dx,dy,dz,0
                  wg_ref,         # (T, G*16, K_pad) Woop planes per cell
                  t_out, slot_out):   # (RB,)
    """One program = RB rays of one visit block. Per visit and per
    KC-lane chunk: 9 FMA rows, one divide, four compares and a row
    minimum over (RB, KC) registers; the per-ray best (t, slot) is the
    only loop-carried state."""
    n_step = counts_ref[0, 0]
    n_gran = wg_ref.shape[0]
    t_max0 = rays_ref[3, :]
    o = [rays_ref[ax, :][:, None] for ax in range(3)]          # (RB, 1)
    d = [rays_ref[4 + ax, :][:, None] for ax in range(3)]

    def gid(i):
        # clamp into the live prefix of the list and to a real cell id
        # (an empty list's slot 0 holds the invalid id t_c)
        j = jnp.clip(jnp.minimum(i, n_step - 1), 0, m_c - 1)
        return jnp.minimum(ids_ref[0, j], n_gran - 1)

    def body(state):
        i, _, best_t, best_s = state
        cur = gid(i)
        for j in range(super_g):
            for c0 in range(0, k_pad, kc):
                rows = [wg_ref[cur, 16 * j + r, pl.ds(c0, kc)][None, :]
                        for r in range(12)]                    # (1, KC)

                def xf(r0):   # ([o, 1] · rows, [d, 0] · rows)
                    ov = (rows[r0 + 3] + o[0] * rows[r0]
                          + o[1] * rows[r0 + 1] + o[2] * rows[r0 + 2])
                    dv = (d[0] * rows[r0] + d[1] * rows[r0 + 1]
                          + d[2] * rows[r0 + 2])
                    return ov, dv                              # (RB, KC)

                ou, du = xf(0)
                ov, dv = xf(4)
                ow, dw = xf(8)
                valid = jnp.abs(dw) > 1e-12
                t = -ow / jnp.where(valid, dw, 1.0)
                u = ou + t * du
                v = ov + t * dv
                hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                       & (t > t_epsilon))
                t_hit = jnp.where(hit, t, 1e30)
                m = jnp.min(t_hit, axis=1)
                lane = jnp.argmin(t_hit, axis=1).astype(jnp.int32)
                upd = m < best_t        # strict: earliest visit wins
                best_t = jnp.where(upd, m, best_t)
                best_s = jnp.where(
                    upd, (cur * super_g + j) * k_size + c0 + lane, best_s)
        if any_hit:
            # (a max over int32: Triton lowers no boolean reduction)
            done = jnp.max(((best_t >= t_max0) & (t_max0 > 0))
                           .astype(jnp.int32)) == 0
        else:
            # front to back: once every ray's best precedes the next
            # cell's entry lower bound, no later cell can win
            done = jnp.max(best_t) <= tnears_ref[0, jnp.minimum(i + 1,
                                                                m_c - 1)]
        return i + 1, done, best_t, best_s

    def cond(state):
        i, done, _, _ = state
        return (i < n_step) & ~done

    _, _, best_t, best_s = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(False), t_max0,
                     jnp.zeros(t_max0.shape, jnp.int32)))
    found = best_t < t_max0
    t_out[:] = jnp.where(found, best_t, t_max0)
    slot_out[:] = jnp.where(found, best_s, -1)


@functools.partial(jax.jit, static_argnames=("super_g", "k_size",
                                             "t_epsilon", "any_hit"))
def _run_visit_kernel(rays8, ids, counts, tnears, wgran,
                      super_g: int, k_size: int, t_epsilon: float,
                      any_hit: bool):
    """rays8 (NB*8, BLOCK); ids/tnears (NB, M); counts (NB,).
    Returns per-ray (t, slot) in block-ray order. Interpreted only on the
    CPU backend (tests); compiled through Triton everywhere else."""
    nb, m_c = ids.shape
    kc = min(KC, 1 << max(k_size - 1, 0).bit_length())
    k_pad = -(-k_size // kc) * kc
    if k_pad != k_size:   # all-zero planes: |dw| = 0 never hits
        wgran = jnp.pad(wgran, ((0, 0), (0, 0), (0, k_pad - k_size)))
    sub = BLOCK // RB
    kernel = functools.partial(_visit_kernel, super_g, k_size, k_pad, kc,
                               m_c, t_epsilon, any_hit)
    t, slot = pl.pallas_call(
        kernel,
        backend="triton",
        interpret=jax.default_backend() == "cpu",
        name="visit_any_hit" if any_hit else "visit_closest",
        grid=(nb * sub,),
        in_specs=[
            pl.BlockSpec((1, m_c), lambda p: (p // sub, 0)),
            pl.BlockSpec((1, 1), lambda p: (p // sub, 0)),
            pl.BlockSpec((1, m_c), lambda p: (p // sub, 0)),
            pl.BlockSpec((8, RB), lambda p: (p // sub, p % sub)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=[pl.BlockSpec((RB,), lambda p: (p,)),
                   pl.BlockSpec((RB,), lambda p: (p,))],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        out_shape=[jax.ShapeDtypeStruct((nb * BLOCK,), jnp.float32),
                   jax.ShapeDtypeStruct((nb * BLOCK,), jnp.int32)],
    )(ids, counts.reshape(-1, 1), tnears, rays8, wgran)
    return t, slot


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _pack_rays8(origins, directions, t_hi):
    n = origins.shape[0]
    nb = n // BLOCK
    o = origins.reshape(nb, BLOCK, 3).transpose(0, 2, 1)
    d = directions.reshape(nb, BLOCK, 3).transpose(0, 2, 1)
    tm = t_hi.reshape(nb, 1, BLOCK)
    zero = jnp.zeros((nb, 1, BLOCK), jnp.float32)
    return jnp.concatenate([o, tm, d, zero], axis=1).reshape(nb * 8, BLOCK)


def _pad_rays(origins, directions, t_max):
    r = origins.shape[0]
    pad = (-r) % BLOCK
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.zeros((pad, 3), origins.dtype)])
        directions = jnp.concatenate(
            [directions, jnp.ones((pad, 3), directions.dtype)])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
    return origins, directions, t_max, r


def _sort_carry_in(tl, origins, directions, t_max):
    """Coherence-sort rays by carrying them THROUGH one multi-operand
    ``lax.sort`` instead of argsort + row gathers. A lane iota as the
    second sort key makes the order exactly the stable argsort order, so
    results are bitwise-identical to the gather path. Returns sorted
    (o, d, t_max, lane); un-permute results with ``_sort_carry_out``."""
    from .compaction import ray_sort_keys
    lo = tl["scene_lo"] if "scene_lo" in tl else tl["bmin"].min(axis=0)
    hi = tl["scene_hi"] if "scene_hi" in tl else tl["bmax"].max(axis=0)
    keys = ray_sort_keys(origins, directions, lo, hi)
    keys = keys + jnp.where(t_max <= 0, jnp.uint32(1) << 28, 0).astype(
        jnp.uint32)
    lane = jnp.arange(origins.shape[0], dtype=jnp.uint32)
    srt = jax.lax.sort(
        (keys, lane,
         origins[:, 0], origins[:, 1], origins[:, 2],
         directions[:, 0], directions[:, 1], directions[:, 2], t_max),
        dimension=0, num_keys=2)
    o = jnp.stack(srt[2:5], axis=1)
    d = jnp.stack(srt[5:8], axis=1)
    return o, d, srt[8], srt[1]


def _sort_carry_out(lane, *cols):
    """Restore original lane order: one sort keyed by the (unique) lane
    ids, carrying the result columns."""
    srt = jax.lax.sort((lane,) + tuple(cols), dimension=0, num_keys=1)
    return srt[1:]


def _granularity(tl, config: RenderConfig):
    """Visit-granule tables: ('cell': one K-tri cell per visit) or
    ('super': SUPER_G consecutive cells — fewer, fatter visits)."""
    k_size = int(tl["wplanes"].shape[2])
    if config.visit_granularity == "super":
        from ..bvh.wide import SUPER_G
        wp = tl["wplanes"]
        t, rows, k = wp.shape
        wg = wp.reshape(t // SUPER_G, SUPER_G * rows, k)
        bounds = jnp.concatenate([
            tl["sbmin"].T, tl["sbmax"].T,
            jnp.zeros((2, tl["sbmin"].shape[0]), jnp.float32)], axis=0)
        return wg, bounds, SUPER_G, k_size
    bounds = jnp.concatenate([
        tl["bmin"].T, tl["bmax"].T,
        jnp.zeros((2, tl["bmin"].shape[0]), jnp.float32)], axis=0)
    return tl["wplanes"], bounds, 1, k_size


def _trace(scene, origins, directions, t_max, config: RenderConfig,
           any_hit: bool, coherent: bool = False):
    """Visit-list passes to exactness. Returns per-ray (t, slot).
    ``coherent``: enumerate with the per-block envelope (NB x T slab
    tests) instead of per-ray (N x T) — conservative-exact, ~BLOCK x
    cheaper, right for primary tiles / converging shadow rays."""
    tl = scene["treelets"]
    wg, bounds8, super_g, k_size = _granularity(tl, config)
    n = origins.shape[0]
    t_c = bounds8.shape[1]
    t_max = jnp.asarray(t_max, jnp.float32)
    lo = tl["scene_lo"] if "scene_lo" in tl else tl["bmin"].min(axis=0)
    hi = tl["scene_hi"] if "scene_hi" in tl else tl["bmax"].max(axis=0)
    diag = jnp.sqrt(jnp.sum((hi - lo) ** 2))

    # enumerate + sort ONCE per launch (see sort_candidates: keys are
    # geometric, so recull passes just consume successive windows)
    t_hi0 = jnp.where(t_max <= 0, 0.0, t_max)
    rays8_0 = _pack_rays8(origins, directions, t_hi0)
    with jax.named_scope("visit_enumerate"):
        b_entry = (block_entries_envelope(rays8_0, bounds8)
                   if coherent else block_entries(rays8_0, bounds8))
    with jax.named_scope("visit_sort"):
        keys_all, counts_all = sort_candidates(b_entry, diag, M_C)

    def one_pass(state):
        it, best_t, best_slot, finished = state
        t_hi = jnp.minimum(t_max, best_t)
        if any_hit:
            t_hi = jnp.where(best_slot >= 0, 0.0, t_hi)
        t_hi = jnp.where(finished, 0.0, t_hi)
        rays8 = _pack_rays8(origins, directions, t_hi)
        ids, counts, tnears, next_tnear = window_candidates(
            keys_all, counts_all, it, diag, M_C, t_c)
        t_row, s_row = _run_visit_kernel(
            rays8, ids, counts, tnears, wg, super_g, k_size,
            float(config.t_epsilon), any_hit)
        # commit ONLY actual new hits: finished blocks run later passes
        # with t_hi = 0 and return (t = 0, slot = -1) — without the
        # s_row >= 0 guard that "0 < best_t" would clobber every
        # previously committed hit
        better = (s_row >= 0) & (t_row < jnp.minimum(best_t, t_max))
        new_t = jnp.where(better, t_row, best_t)
        new_slot = jnp.where(better, s_row, best_slot)
        # a ray is done when its block's window list is exhausted, when
        # its best hit precedes the next window's first entry bound
        # (front-to-back: no later cell can beat it), or — for
        # occlusion — as soon as anything hit.
        overflow = counts_all > (it + 1) * M_C
        blk_of = jnp.repeat(overflow, BLOCK)[:n]
        ray_next = jnp.repeat(next_tnear, BLOCK)[:n]
        if any_hit:
            fin = finished | ~blk_of | (new_slot >= 0)
        else:
            fin = finished | ~blk_of | (new_t <= ray_next)
        return it + 1, new_t, new_slot, fin

    # exact pass bound: every window of the one-shot candidate table
    n_windows = keys_all.shape[1] // M_C

    def cond(state):
        it, _, _, finished = state
        return (it < n_windows) & ~jnp.all(finished)

    state = (jnp.int32(0), jnp.broadcast_to(t_max, (n,)),
             jnp.full(n, -1, jnp.int32), t_max <= 0)
    _, t, slot, _ = jax.lax.while_loop(cond, one_pass, state)
    return t, slot


def closest_hit(scene, origins, directions, config: RenderConfig,
                t_max=None, sort: bool = True, coherent: bool = False):
    """Intersector ABI: (t, prim, u, v); lanes with t_max == 0 are dead.
    ``sort=False`` for streams already in a coherent order; ``coherent``
    additionally enables the per-block envelope enumeration (valid with
    or without the internal sort — blocks are whatever order the stream
    lands in; callers set it when blocks are TIGHT: primary tiles,
    light-converging shadow rays). The winner is refined with
    Möller–Trumbore in exact f32."""
    tl = scene["treelets"]
    n = origins.shape[0]
    if t_max is None:
        t_max = jnp.full(n, BIG_T)
    t_max = jnp.broadcast_to(t_max, (n,))
    lane = None
    if sort:
        origins, directions, t_max, lane = _sort_carry_in(
            tl, origins, directions, t_max)
    o, d, tm, r = _pad_rays(origins, directions, t_max)
    t, slot = _trace(scene, o, d, tm, config, any_hit=False,
                     coherent=coherent)
    t, slot = t[:r], slot[:r]
    found = slot >= 0
    prim = jnp.where(found, tl["slot_to_prim"][jnp.maximum(slot, 0)], -1)
    found = found & (prim >= 0)

    tv = tl["verts"][jnp.maximum(slot, 0)]
    rhit, rt, ru, rv = intersect_tri(
        o[:r], d[:r], tv[:, 0], tv[:, 1] - tv[:, 0],
        tv[:, 2] - tv[:, 0], t_epsilon=config.t_epsilon * 0.5)
    t = jnp.where(found, jnp.where(rhit, rt, t), BIG_T)
    prim = jnp.where(found, prim, -1)
    u = jnp.where(found & rhit, ru, 0.0)
    v = jnp.where(found & rhit, rv, 0.0)
    if lane is None:
        return t, prim, u, v
    return _sort_carry_out(lane, t, prim, u, v)


def any_hit(scene, origins, directions, dist, config: RenderConfig,
            sort: bool = True, coherent: bool = False):
    """Occlusion: True where something lies closer than ``dist``."""
    tl = scene["treelets"]
    n = origins.shape[0]
    dist = jnp.broadcast_to(dist, (n,))
    lane = None
    if sort:
        origins, directions, dist, lane = _sort_carry_in(
            tl, origins, directions, dist)
    o, d, tm, r = _pad_rays(origins, directions, dist)
    _, slot = _trace(scene, o, d, tm, config, any_hit=True,
                     coherent=coherent)
    slot = slot[:r]
    occluded = jnp.where(
        slot >= 0, tl["slot_to_prim"][jnp.maximum(slot, 0)], -1) >= 0
    if lane is None:
        return occluded
    # carry as i32 (PRED-typed sort operands are backend-fragile)
    (occ_i,) = _sort_carry_out(lane, occluded.astype(jnp.int32))
    return occ_i > 0
