"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

One ray per lane, one program per ``BLOCK`` rays of the flattened
tile-major ray stream. Each lane walks the threaded (skip-link) BVH of
``accel/bvh.py`` on its own — a box hit on an inner node descends to
``node + 1``, anything else follows the ``miss`` link — with its whole
state (origin, direction, best hit, node pointer) in registers for the
length of the walk. Node and triangle records are gathered per lane from
device memory; a scene's tables are a few tens of MB and stay in the L2.

The instance loop and the world-to-object transform run inside the
kernel: every ray visits each instance's mesh in turn, exactly like the
XLA packet walk (``ops/packet.py``) it replaces on the card, so there is
no per-instance glue between kernels. The closest-hit kernel carries
``t / slot / u / v / inst`` and interpolates the world-space shading
normal of the hit before it returns; the any-hit kernel retires a lane at
its first accepted hit.

Differences from the packet walk, all confined to measure-zero rays:

* a leaf's triangles are tested only when the ray hits the leaf's box
  (the packet walk tests a leaf reached by a skip link unconditionally);
  a triangle the ray grazes at the box boundary can fall either way;
* the compiled min/max ignore NaN (``0 * inf`` in the slab test of a ray
  that lies in a slab plane), where XLA's propagate it.

``interpret=True`` runs the same kernel through the Pallas interpreter on
the CPU; the tests use it, the renderer never does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytpu.ops.intersect import BIG_T, DET_EPS

# rays per program and warps per program; a power of two (Triton's block
# rule). One warp of 32 rays per program: a warp iterates until its longest
# walk ends, and a smaller block wastes fewer lanes on it. On an H100
# (700 W) the config4 primary closest sweep took 1.38 ms at 32/1 against
# 1.64-2.87 ms at 64/1, 64/2, 128/2, 128/4 and 256/4 (PERF.md).
BLOCK = 32
NUM_WARPS = 1

# node record: six box floats (as int32 bits), meta, miss — 32 bytes
NODE_WORDS = 8
# meta = first_slot << META_SHIFT | count for a leaf, -1 for an inner node
META_SHIFT = 4
# triangle record: v0, e1, e2 (9 floats)
TRI_WORDS = 9


class KernelTables(NamedTuple):
    """The traversal tables in the kernel's layout (device arrays)."""

    nodes: jnp.ndarray   # (M * NODE_WORDS,) int32, global slots and links
    tris: jnp.ndarray    # (T * TRI_WORDS,) float32, BVH slot order
    normals: jnp.ndarray  # (T * 9,) float32 corner normals, BVH slot order


def pack_tables(aabb_min, aabb_max, tri_first, tri_count, miss,
                node_ranges, tri_ranges, tri_v0, tri_e1, tri_e2,
                tri_n_soa) -> KernelTables:
    """Host-side packing of the concatenated per-mesh BVH arrays.

    ``miss`` and ``tri_first`` are mesh-local in the BVH arrays; the packed
    records hold global node and slot indices so the kernel needs no
    per-mesh base arithmetic."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    first = np.asarray(tri_first, np.int64).copy()
    count = np.asarray(tri_count, np.int64)
    miss_g = np.asarray(miss, np.int64).copy()
    for (nb, nc), (tb, _) in zip(node_ranges, tri_ranges):
        sl = slice(nb, nb + nc)
        miss_g[sl] += nb
        leaf = first[sl] >= 0
        first[sl] = np.where(leaf, first[sl] + tb, -1)
    if count.max(initial=0) >= (1 << META_SHIFT):
        raise ValueError(f"leaf size must stay below {1 << META_SHIFT}")
    if first.max(initial=0) >= (1 << (31 - META_SHIFT)):
        raise ValueError("too many triangles for the node meta word")
    meta = np.where(first >= 0, (first << META_SHIFT) | count, -1)
    rec = np.empty((aabb_min.shape[0], NODE_WORDS), np.int32)
    rec[:, 0:3] = aabb_min.view(np.int32)
    rec[:, 3:6] = aabb_max.view(np.int32)
    rec[:, 6] = meta.astype(np.int32)
    rec[:, 7] = miss_g.astype(np.int32)
    tris = np.concatenate(
        [np.asarray(tri_v0, np.float32), np.asarray(tri_e1, np.float32),
         np.asarray(tri_e2, np.float32)], axis=1)
    normals = np.ascontiguousarray(np.asarray(tri_n_soa, np.float32).T)
    return KernelTables(
        nodes=jnp.asarray(rec.reshape(-1)),
        tris=jnp.asarray(tris.reshape(-1)),
        normals=jnp.asarray(normals.reshape(-1)),
    )


def _inv(x):
    return jnp.where(x != 0.0, 1.0 / x, jnp.where(x >= 0.0, jnp.inf, -jnp.inf))


def _any(mask):
    # Triton has no boolean reduction; reduce an int32 view instead
    return jnp.max(mask.astype(jnp.int32)) > 0


def _load_node(node_ref, n):
    base = n * NODE_WORDS
    w = [node_ref[base + j] for j in range(NODE_WORDS)]
    box = [lax.bitcast_convert_type(x, jnp.float32) for x in w[:6]]
    return box[:3], box[3:], w[6], w[7]


def _box_hit(o, inv, bmin, bmax, tmin, tfar):
    tn, tf = [], []
    for c in range(3):
        lo = (bmin[c] - o[c]) * inv[c]
        hi = (bmax[c] - o[c]) * inv[c]
        tn.append(jnp.minimum(lo, hi))
        tf.append(jnp.maximum(lo, hi))
    t_near = jnp.maximum(jnp.maximum(tn[0], tn[1]), jnp.maximum(tn[2], tmin))
    t_far = jnp.minimum(jnp.minimum(tf[0], tf[1]), jnp.minimum(tf[2], tfar))
    return t_near <= t_far


def _triangle(tri_ref, slot, o, d, tmin, tmax):
    """Möller–Trumbore against one gathered triangle per lane, the same
    arithmetic as the packet walk (``ops/packet._mt_packet``)."""
    base = slot * TRI_WORDS
    v0 = [tri_ref[base + j] for j in range(3)]
    e1 = [tri_ref[base + 3 + j] for j in range(3)]
    e2 = [tri_ref[base + 6 + j] for j in range(3)]
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = jnp.abs(det) > DET_EPS
    inv_det = jnp.where(ok, 1.0 / det, 0.0)
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return t, u, v, hit


def _walk(node_ref, tri_ref, o, d, tmin, root, end, state, closest):
    """Walk one mesh's threaded BVH (global nodes ``[root, end)``).

    ``state`` is ``(t, slot, u, v)`` for the closest-hit walk and
    ``(tmax, occluded)`` for the any-hit walk; lanes whose window is empty
    start parked at ``end``."""
    inv = tuple(_inv(x) for x in d)
    window = state[0]
    node0 = jnp.where(window > tmin, root, end)
    if not closest:
        node0 = jnp.where(state[1] != 0, end, node0)

    def cond(carry):
        return _any(carry[0] != end)

    def body(carry):
        node, *st = carry
        live = node != end
        n = jnp.where(live, node, root)
        bmin, bmax, meta, miss = _load_node(node_ref, n)
        t_cap = st[0]
        hit_box = live & _box_hit(o, inv, bmin, bmax, tmin, t_cap)
        leaf = hit_box & (meta >= 0)
        first = jnp.where(leaf, meta >> META_SHIFT, 0)
        count = jnp.where(leaf, meta & ((1 << META_SHIFT) - 1), 0)

        def tri_body(k, st):
            valid = k < count
            slot = jnp.where(valid, first + k, 0)
            if closest:
                bt, bs, bu, bv = st
                t, u, v, hit = _triangle(tri_ref, slot, o, d, tmin, bt)
                hit = hit & valid
                return (jnp.where(hit, t, bt), jnp.where(hit, slot, bs),
                        jnp.where(hit, u, bu), jnp.where(hit, v, bv))
            tmax, occ = st
            _, _, _, hit = _triangle(tri_ref, slot, o, d, tmin, tmax)
            return tmax, jnp.where(hit & valid, 1, occ)

        st = lax.fori_loop(0, jnp.max(count), tri_body, tuple(st))
        nxt = jnp.where(hit_box & (meta < 0), node + 1, miss)
        done = ~live if closest else (~live | (st[1] != 0))
        return (jnp.where(done, end, nxt),) + tuple(st)

    out = lax.while_loop(cond, body, (node0,) + tuple(state))
    return out[1:]


def _transform(w, o, d):
    """World ray → object space by the (3, 4) world-to-object rows ``w``
    (scalars); directions are not renormalized, so ``t`` stays in world
    units (ops/intersect.py)."""
    oo = tuple(w[r][0] * o[0] + w[r][1] * o[1] + w[r][2] * o[2] + w[r][3]
               for r in range(3))
    dd = tuple(w[r][0] * d[0] + w[r][1] * d[1] + w[r][2] * d[2]
               for r in range(3))
    return oo, dd


def _load_w2o(w2o_ref, inst):
    return [[w2o_ref[inst * 12 + r * 4 + c] for c in range(4)]
            for r in range(3)]


def _closest_kernel(trav, tmin, w2o_ref, ox, oy, oz, dx, dy, dz, tmax_ref,
                    node_ref, tri_ref, nrm_ref,
                    t_out, slot_out, inst_out, u_out, v_out,
                    nx_out, ny_out, nz_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    t = tmax_ref[...]
    slot = jnp.full(t.shape, -1, jnp.int32)
    inst = jnp.full(t.shape, -1, jnp.int32)
    u = jnp.zeros(t.shape, jnp.float32)
    v = jnp.zeros(t.shape, jnp.float32)
    ws = {}
    for inst_id, root, end in trav:
        if inst_id not in ws:
            ws[inst_id] = _load_w2o(w2o_ref, inst_id)
        oo, dd = _transform(ws[inst_id], o, d)
        t_in = t
        t, slot, u, v = _walk(node_ref, tri_ref, oo, dd, tmin, root, end,
                              (t, slot, u, v), closest=True)
        inst = jnp.where(t < t_in, inst_id, inst)
    found = slot >= 0
    # interpolated object-space normal of the hit, then the instance's
    # inverse-transpose (row vector times the world-to-object linear part)
    base = jnp.where(found, slot, 0) * 9
    w0 = 1.0 - u - v
    n_obj = tuple(
        w0 * nrm_ref[base + c] + u * nrm_ref[base + 3 + c]
        + v * nrm_ref[base + 6 + c]
        for c in range(3)
    )
    n = (jnp.zeros_like(t), jnp.zeros_like(t), jnp.ones_like(t))
    for inst_id, w in ws.items():
        cand = tuple(w[0][c] * n_obj[0] + w[1][c] * n_obj[1]
                     + w[2][c] * n_obj[2] for c in range(3))
        sel = inst == inst_id
        n = tuple(jnp.where(sel, cand[c], n[c]) for c in range(3))
    t_out[...] = jnp.where(found, t, BIG_T)
    slot_out[...] = slot
    inst_out[...] = inst
    u_out[...] = u
    v_out[...] = v
    nx_out[...] = n[0]
    ny_out[...] = n[1]
    nz_out[...] = n[2]


def _anyhit_kernel(trav, tmin, w2o_ref, ox, oy, oz, dx, dy, dz, tmax_ref,
                   node_ref, tri_ref, occ_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    tmax = tmax_ref[...]
    occ = jnp.zeros(tmax.shape, jnp.int32)
    ws = {}
    for inst_id, root, end in trav:
        if inst_id not in ws:
            ws[inst_id] = _load_w2o(w2o_ref, inst_id)
        oo, dd = _transform(ws[inst_id], o, d)
        _, occ = _walk(node_ref, tri_ref, oo, dd, tmin, root, end,
                       (tmax, occ), closest=False)
    occ_out[...] = occ


class KernelHit(NamedTuple):
    """Closest-hit kernel output, one entry per ray."""

    t: jnp.ndarray     # float32, BIG_T on miss
    slot: jnp.ndarray  # int32 BVH triangle slot, -1 on miss
    inst: jnp.ndarray  # int32 instance id, -1 on miss
    u: jnp.ndarray
    v: jnp.ndarray
    n: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]  # world normal, unnormalized


def _call(kernel, outs, trav, tmin, w2o, o, d, tmax, tables, interpret):
    r = o[0].shape[0]
    pad = (-r) % BLOCK
    rays = [jnp.pad(x.astype(jnp.float32), (0, pad)) for x in (*o, *d)]
    # padding lanes get an empty window, so they park at once
    win = jnp.pad(jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,)),
                  (0, pad))
    rp = r + pad
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,))

    table_args = [tables.nodes, tables.tris]
    if len(outs) > 1:
        table_args.append(tables.normals)
    w2o_flat = jnp.asarray(w2o, jnp.float32).reshape(-1)
    res = pl.pallas_call(
        functools.partial(kernel, trav, tmin),
        out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in outs],
        grid=(rp // BLOCK,),
        in_specs=[whole(w2o_flat)] + [ray_spec] * 7
        + [whole(x) for x in table_args],
        out_specs=[ray_spec] * len(outs),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(w2o_flat, *rays, win, *table_args)
    return [x[:r] for x in res]


def traversal_entries(static) -> Tuple[Tuple[int, int, int], ...]:
    """``(instance, first node, end node)`` per instance, in visit order."""
    out = []
    for inst_id, mesh_id in static.traversal_list:
        nb, nc = static.mesh_node_ranges[mesh_id]
        out.append((inst_id, nb, nb + nc))
    return tuple(out)


def closest(scene, static, o, d, tmin: float, tmax, *,
            interpret: bool = False) -> KernelHit:
    """Closest hit over every instance for flat (R,) world rays."""
    f32, i32 = jnp.float32, jnp.int32
    t, slot, inst, u, v, nx, ny, nz = _call(
        _closest_kernel, (f32, i32, i32, f32, f32, f32, f32, f32),
        traversal_entries(static), float(tmin), scene.w2o, o, d, tmax,
        scene.kernel_tables, interpret)
    return KernelHit(t=t, slot=slot, inst=inst, u=u, v=v, n=(nx, ny, nz))


def anyhit(scene, static, o, d, tmin: float, tmax, *,
           interpret: bool = False) -> jnp.ndarray:
    """Occlusion over every instance for flat (R,) world rays → bool (R,)."""
    (occ,) = _call(
        _anyhit_kernel, (jnp.int32,), traversal_entries(static), float(tmin),
        scene.w2o, o, d, tmax, scene.kernel_tables, interpret)
    return occ != 0
