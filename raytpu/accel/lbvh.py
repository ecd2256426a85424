"""LBVH: Morton-code radix BVH built ON DEVICE in JAX.

The device-side acceleration-structure builder (SURVEY.md §2: the renderer
must own what the Vulkan driver provides at ``src/main.cpp:495-498``). The
construction is the classic parallel formulation (Karras-style binary radix
tree over sorted Morton codes):

1. 30-bit Morton codes of triangle centroids (elementwise bit-interleave);
2. ``jnp.argsort`` (XLA's parallel sort);
3. binary radix tree: each internal node's range/split found with fixed
   32-step vectorized binary searches over common-prefix lengths
   (``jax.lax.clz``) — every node computed independently, no recursion;
4. bottom-up AABB refit via fixed-depth sweeps.

Everything through step 4 runs under jit on the device — this is the
rebuild-capable path (a deforming mesh could re-run it per frame). The final
threading into the skip-link layout consumed by the traversal kernels is
vectorized NumPy (two sorts + a searchsorted over the Karras leaf ranges —
no per-node Python loop), so rebuild cost stays sort-bound at every size.

Quality note: LBVH trees are faster to build but trace slower than binned
SAH (``accel/bvh.py`` / ``native/bvh_build.cpp``), which remain the default
for static scenes; select with ``RenderConfig.bvh_builder = "lbvh"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.accel.bvh import Bvh


def _expand_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits to every 3rd position (Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes_jax(cent: jnp.ndarray) -> jnp.ndarray:
    """(T, 3) centroids → (T,) int32 30-bit Morton codes (normalized to the
    centroid AABB)."""
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    ext = jnp.maximum(hi - lo, 1e-30)
    q = jnp.clip(((cent - lo) / ext) * 1023.0, 0, 1023).astype(jnp.int32)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


@jax.jit
def build_radix_tree(codes_sorted: jnp.ndarray):
    """Karras-style binary radix tree over sorted Morton codes.

    Returns (left, right) child indices for the N-1 internal nodes:
    ``0 ≤ c < N`` encodes leaf ``c``; ``c ≥ N`` encodes internal ``c - N``.
    Duplicate codes are disambiguated by index (the standard augmented key).
    """
    n = codes_sorted.shape[0]
    idx = jnp.arange(n - 1, dtype=jnp.int32)

    def delta(i, j):
        """Common-prefix length of augmented keys; -1 out of range."""
        valid = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        ci = codes_sorted[i]
        cj = codes_sorted[jc]
        diff = ci ^ cj
        # augmented key: on equal codes, fall through to index bits
        # (+32 prefix bits) — the standard duplicate-code disambiguation
        d = jnp.where(
            diff == 0,
            32 + jax.lax.clz(jnp.maximum(i ^ jc, 1)),
            jax.lax.clz(jnp.maximum(diff, 1)),
        )
        return jnp.where(valid, d, -1)

    d_dir = jnp.sign(delta(idx, idx + 1) - delta(idx, idx - 1)).astype(jnp.int32)
    d_dir = jnp.where(d_dir == 0, 1, d_dir)
    delta_min = delta(idx, idx - d_dir)

    # range length upper bound: exponential search, 32 fixed steps
    def lmax_body(k, lmax):
        probe = idx + lmax * d_dir
        grow = delta(idx, probe) > delta_min
        return jnp.where(grow, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, 32, lmax_body, jnp.full_like(idx, 2))

    # binary search the exact other end
    def l_body(k, carry):
        l, t = carry
        t = jnp.maximum(t // 2, 0)
        probe = idx + (l + t) * d_dir
        ok = (t > 0) & (delta(idx, probe) > delta_min)
        return jnp.where(ok, l + t, l), t

    l, _ = jax.lax.fori_loop(0, 33, l_body, (jnp.zeros_like(idx), lmax))
    j = idx + l * d_dir

    # split position: binary search on the node's own prefix
    delta_node = delta(idx, j)

    def s_body(k, carry):
        s, t = carry
        t = (t + 1) // 2
        probe = idx + (s + t) * d_dir
        ok = (s + t < l) & (delta(idx, probe) > delta_node)
        s = jnp.where(ok, s + t, s)
        t = jnp.where(t > 1, t, 0)
        return s, t

    s, _ = jax.lax.fori_loop(0, 33, s_body, (jnp.zeros_like(idx), l))
    gamma = idx + s * d_dir + jnp.minimum(d_dir, 0)

    left_is_leaf = jnp.minimum(idx, j) == gamma
    right_is_leaf = jnp.maximum(idx, j) == gamma + 1
    left = jnp.where(left_is_leaf, gamma, gamma + n)
    right = jnp.where(right_is_leaf, gamma + 1, gamma + 1 + n)
    # each internal node covers the CONTIGUOUS sorted-leaf range
    # [min(i,j), max(i,j)] — the property the vectorized threading and
    # leaf collapsing below build on
    lo = jnp.minimum(idx, j)
    hi = jnp.maximum(idx, j)
    return left, right, lo, hi


@jax.jit
def refit_aabbs(left, right, leaf_min, leaf_max):
    """Bottom-up AABB refit by fixed-depth sweeps (device-friendly: each
    sweep is gathers + elementwise min/max; converges in tree depth)."""
    n = leaf_min.shape[0]
    m = n - 1
    node_min = jnp.full((m, 3), jnp.inf, jnp.float32)
    node_max = jnp.full((m, 3), -jnp.inf, jnp.float32)

    def child_box(c, node_min, node_max):
        is_leaf = c < n
        ci = jnp.clip(c, 0, n - 1)
        ii = jnp.clip(c - n, 0, m - 1)
        bmin = jnp.where(is_leaf[:, None], leaf_min[ci], node_min[ii])
        bmax = jnp.where(is_leaf[:, None], leaf_max[ci], node_max[ii])
        return bmin, bmax

    def sweep(_, carry):
        node_min, node_max = carry
        lmin, lmax_ = child_box(left, node_min, node_max)
        rmin, rmax_ = child_box(right, node_min, node_max)
        return jnp.minimum(lmin, rmin), jnp.maximum(lmax_, rmax_)

    # depth of a radix tree over 30+32-bit keys is ≤ 64
    node_min, node_max = jax.lax.fori_loop(0, 64, sweep, (node_min, node_max))
    return node_min, node_max


def build_lbvh(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int = 4
) -> Bvh:
    """Device LBVH build → vectorized-threaded :class:`Bvh` (same layout
    contract as the SAH builders).

    Steps 1–4 (codes, sort, radix tree, refit) run jitted on the device;
    the final threading into the skip-link layout is VECTORIZED NumPy (two
    sorts + a searchsorted — no Python-level tree walk), exploiting the
    Karras-range property: every node covers a contiguous sorted-leaf range
    [lo, hi], so DFS order is lexsort by (lo asc, size desc) and each skip
    link is the first later node with lo > hi. Subtrees with ≤ ``leaf_size``
    triangles are collapsed into packed leaves (their slot ranges are
    contiguous in Morton order by the same property)."""
    t = int(v0.shape[0])
    if t <= max(1, leaf_size):
        from raytpu.accel.bvh import build_bvh

        return build_bvh(v0, e1, e2, leaf_size=leaf_size)

    v0j = jnp.asarray(v0, jnp.float32)
    e1j = jnp.asarray(e1, jnp.float32)
    e2j = jnp.asarray(e2, jnp.float32)
    v1 = v0j + e1j
    v2 = v0j + e2j
    tmin = jnp.minimum(jnp.minimum(v0j, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0j, v1), v2)
    cent = (tmin + tmax) * 0.5

    codes = morton_codes_jax(cent)
    order = jnp.argsort(codes)
    codes_sorted = codes[order]

    left, right, lo_i, hi_i = build_radix_tree(codes_sorted)
    node_min, node_max = refit_aabbs(left, right, tmin[order], tmax[order])

    # ---- vectorized threading into the skip-link layout ----
    n = t
    left_np = np.asarray(left).astype(np.int64)
    right_np = np.asarray(right).astype(np.int64)
    lo_i = np.asarray(lo_i).astype(np.int64)     # (n-1,) internal ranges
    hi_i = np.asarray(hi_i).astype(np.int64)
    nmin = np.asarray(node_min)
    nmax = np.asarray(node_max)
    order_np = np.asarray(order)
    lmin = np.asarray(tmin)[order_np]
    lmax = np.asarray(tmax)[order_np]

    count_i = hi_i - lo_i + 1                    # (n-1,)
    # parent's triangle count for every node (encoded: leaf c<n, internal
    # n+i), via one scatter — the root has no parent (count = n+1 sentinel)
    pcount = np.full(2 * n - 1, n + 1, np.int64)
    pcount[left_np] = count_i
    pcount[right_np] = count_i

    # emitted nodes: interior (count > leaf_size), collapsed-leaf internal
    # nodes (count ≤ leaf_size, topmost: parent count > leaf_size), and
    # original leaves whose parent was not collapsed
    int_keep = count_i > leaf_size
    int_leaf = (~int_keep) & (pcount[n:] > leaf_size)
    leaf_keep = pcount[:n] > leaf_size

    lo_all = np.concatenate([
        lo_i[int_keep], lo_i[int_leaf], np.arange(n)[leaf_keep]
    ])
    hi_all = np.concatenate([
        hi_i[int_keep], hi_i[int_leaf], np.arange(n)[leaf_keep]
    ])
    is_leaf = np.concatenate([
        np.zeros(int_keep.sum(), bool),
        np.ones(int_leaf.sum() + leaf_keep.sum(), bool),
    ])
    bmin_all = np.concatenate([
        nmin[int_keep], nmin[int_leaf], lmin[leaf_keep]
    ])
    bmax_all = np.concatenate([
        nmax[int_keep], nmax[int_leaf], lmax[leaf_keep]
    ])

    # DFS order: ranges nest, parents share lo with their leftmost
    # descendant and are strictly larger → (lo asc, size desc)
    dfs = np.lexsort((-(hi_all - lo_all), lo_all))
    lo_s = lo_all[dfs]
    hi_s = hi_all[dfs]
    m = dfs.size
    # skip link = first later node outside the subtree: lo is
    # non-decreasing in DFS order, so it is searchsorted(lo, hi+1)
    miss = np.searchsorted(lo_s, hi_s + 1, side="left").astype(np.int32)

    leaf_s = is_leaf[dfs]
    tri_first = np.where(leaf_s, lo_s, -1).astype(np.int32)
    tri_count = np.where(leaf_s, hi_s - lo_s + 1, 0).astype(np.int32)

    eps = 1e-6 * np.maximum(
        1.0, np.abs(bmax_all[dfs] - bmin_all[dfs])
    )
    return Bvh(
        aabb_min=(bmin_all[dfs] - eps).astype(np.float32),
        aabb_max=(bmax_all[dfs] + eps).astype(np.float32),
        tri_first=tri_first,
        tri_count=tri_count,
        miss=miss,
        tri_order=order_np.astype(np.int32),
    )
