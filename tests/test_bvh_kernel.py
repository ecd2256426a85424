"""The GPU traversal kernel (``ops/bvh_kernel.py``) against the XLA packet
walk and brute force.

Here the kernel runs through the Pallas interpreter on the CPU; the tests
marked ``gpu`` compile it for the card and run only there
(``python chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.io.genmesh import cube, generate_highpoly
from raytpu.ops import bvh_kernel, trace
from raytpu.ops.intersect import brute_anyhit, brute_closest
from raytpu.render import Renderer
from raytpu.scene import load_scene, mat_rotate_y

TMIN = 1e-3


def _renderer(leaf_size, mat=MaterialType.DIFFUSE):
    cfg = RenderConfig(
        objects=(ObjectConfig("ball", mat, "static"),
                 ObjectConfig("box", MaterialType.MIRROR, "orbit")),
        width=8, height=8, samples_per_pixel=1, max_bounce_count=1,
        leaf_size=leaf_size, bvh_builder="sah",
    )
    scene = load_scene(cfg, meshes=[generate_highpoly(depth=2), cube()],
                       skybox=np.full((6, 4, 4, 3), 0.5, np.float32))
    return Renderer(scene)


def _transforms(rotated):
    """(o2w, w2o) for the two instances: identity + a translated box, or
    both rotated, scaled non-uniformly and moved (t stays in world units
    because directions are not renormalized in object space)."""
    m0, m1 = np.eye(4), np.eye(4)
    m1[:3, 3] = (0.5, 0.2, 1.8)
    if rotated:
        m0 = mat_rotate_y(0.7) @ np.diag([1.3, 0.8, 1.1, 1.0])
        rx = np.eye(4)
        c, s = np.cos(0.9), np.sin(0.9)
        rx[1:3, 1:3] = [[c, -s], [s, c]]
        m1 = m1 @ rx @ mat_rotate_y(-0.4) @ np.diag([0.6, 0.6, 0.9, 1.0])
    o2w = np.stack([m0[:3], m1[:3]]).astype(np.float32)
    w2o = np.stack([np.linalg.inv(m)[:3] for m in (m0, m1)]).astype(np.float32)
    return o2w, w2o


def _rays(n, dead_frac, seed=0):
    """Rays from a box in front of the scene toward random targets on it;
    a ``dead_frac`` share of lanes gets an empty window."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0.0, 0.0, 5.0])
    tgt = rng.uniform(-1.2, 1.2, (n, 3)) + np.array([0.2, 0.0, 0.8])
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < dead_frac, 0.0, 1e4)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def _world_brute(r, o, d, tmax, closest):
    """Brute force per instance in object space, merged in world t."""
    dev, static = r.device_scene, r.static
    best_t = np.full(len(o), np.inf, np.float32)
    best_i = np.full(len(o), -1)
    occ = np.zeros(len(o), bool)
    for inst, mesh in static.traversal_list:
        w = np.asarray(dev.w2o[inst])
        oo = o @ w[:, :3].T + w[:, 3]
        dd = d @ w[:, :3].T
        s, c = static.mesh_prim_ranges[mesh]
        tri = [dev.tri_v0[s:s + c], dev.tri_e1[s:s + c], dev.tri_e2[s:s + c]]
        if closest:
            t, prim, _, _ = brute_closest(jnp.asarray(oo), jnp.asarray(dd),
                                          *tri, TMIN, jnp.asarray(tmax))
            t, prim = np.asarray(t), np.asarray(prim)
            better = (prim >= 0) & (t < best_t)
            best_t = np.where(better, t, best_t)
            best_i = np.where(better, inst, best_i)
        else:
            occ |= np.asarray(brute_anyhit(jnp.asarray(oo), jnp.asarray(dd),
                                           *tri, TMIN, jnp.asarray(tmax)))
    return (best_t, best_i) if closest else occ


@pytest.mark.parametrize("leaf_size", [1, 12])
@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("n_rays,dead_frac", [(128, 0.0), (197, 0.3)],
                         ids=["block-multiple", "ragged-dead-lanes"])
@pytest.mark.parametrize("mode", ["closest", "anyhit"])
def test_kernel_matches_packet_walk_and_brute(mode, n_rays, dead_frac,
                                             rotated, leaf_size):
    r = _renderer(leaf_size)
    r.device_scene = r.device_scene.with_transforms(*_transforms(rotated))
    o, d, tmax = _rays(n_rays, dead_frac, seed=leaf_size + 2 * rotated)
    # packet layout for the XLA walk: one row of n rays
    o_pk = tuple(jnp.asarray(o[None, :, c]) for c in range(3))
    d_pk = tuple(jnp.asarray(d[None, :, c]) for c in range(3))
    win = jnp.asarray(tmax[None])
    kern = dataclasses.replace(r.static, traversal="kernel", interpret=True)
    assert r.static.traversal == "xla"
    live = tmax > 0
    if mode == "closest":
        ref = trace.closest_hit_wave(r.device_scene, r.static, o_pk, d_pk,
                                     TMIN, win)
        got = trace.closest_hit_wave(r.device_scene, kern, o_pk, d_pk,
                                     TMIN, win)
        valid = np.asarray(got.valid[0])
        assert 0 < valid.sum() < live.sum()          # hits and misses
        assert not valid[~live].any()                # dead lanes never hit
        np.testing.assert_array_equal(valid, np.asarray(ref.valid[0]))
        np.testing.assert_array_equal(np.asarray(got.prim[0]),
                                      np.asarray(ref.prim[0]))
        np.testing.assert_array_equal(np.asarray(got.inst[0]),
                                      np.asarray(ref.inst[0]))
        # float32 with the object-space transform fused differently: a few
        # tens of ulps in the barycentrics
        for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
            np.testing.assert_allclose(np.asarray(a[0])[valid],
                                       np.asarray(b[0])[valid],
                                       rtol=1e-4, atol=1e-5)
        for a, b in zip(got.n, ref.n):
            np.testing.assert_allclose(np.asarray(a[0])[valid],
                                       np.asarray(b[0])[valid], atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.mat[0]),
                                      np.asarray(ref.mat[0]))
        bt, bi = _world_brute(r, o, d, tmax, closest=True)
        np.testing.assert_array_equal(valid, np.isfinite(bt))
        np.testing.assert_allclose(np.asarray(got.t[0])[valid], bt[valid],
                                   rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(got.inst[0]), bi)
    else:
        ref = trace.any_hit_wave(r.device_scene, r.static, o_pk, d_pk,
                                 TMIN, win)
        got = np.asarray(trace.any_hit_wave(r.device_scene, kern, o_pk, d_pk,
                                            TMIN, win)[0])
        assert 0 < got.sum() < live.sum()
        assert not got[~live].any()
        np.testing.assert_array_equal(got, np.asarray(ref[0]))
        np.testing.assert_array_equal(
            got, _world_brute(r, o, d, tmax, closest=False))


def test_anyhit_respects_the_window():
    """Occlusion counts only hits inside (tmin, tmax): shrinking every
    window below the closest hit clears every flag."""
    r = _renderer(4)
    o, d, _ = _rays(128, 0.0, seed=5)
    hit = bvh_kernel.closest(r.device_scene, r.static, tuple(o.T), tuple(d.T),
                             TMIN, np.full(128, 1e4, np.float32),
                             interpret=True)
    t = np.asarray(hit.t)
    found = np.asarray(hit.slot) >= 0
    win = np.where(found, t * 0.999, 1e4).astype(np.float32)
    occ = np.asarray(bvh_kernel.anyhit(r.device_scene, r.static, tuple(o.T),
                                       tuple(d.T), TMIN, win, interpret=True))
    assert not occ.any()
    win = np.where(found, t * 1.001, 0.0).astype(np.float32)
    occ = np.asarray(bvh_kernel.anyhit(r.device_scene, r.static, tuple(o.T),
                                       tuple(d.T), TMIN, win, interpret=True))
    np.testing.assert_array_equal(occ, found)


def test_pack_tables_layout():
    """Node records hold the box bits, a (global first slot, count) meta
    word for leaves / -1 for inner nodes, and the global skip link."""
    r = _renderer(4)
    dev, static = r.device_scene, r.static
    nodes = np.asarray(dev.kernel_tables.nodes).reshape(-1, 8)
    np.testing.assert_array_equal(nodes[:, 0:3].view(np.float32),
                                  np.asarray(dev.bvh_aabb_min))
    np.testing.assert_array_equal(nodes[:, 3:6].view(np.float32),
                                  np.asarray(dev.bvh_aabb_max))
    first = np.asarray(dev.bvh_tri_first)
    count = np.asarray(dev.bvh_tri_count)
    miss = np.asarray(dev.bvh_miss)
    for (nb, nc), (tb, tc) in zip(static.mesh_node_ranges,
                                  static.mesh_bvh_tri_ranges):
        sl = slice(nb, nb + nc)
        leaf = first[sl] >= 0
        meta = nodes[sl, 6]
        assert (meta[~leaf] == -1).all()
        np.testing.assert_array_equal(meta[leaf] >> 4, first[sl][leaf] + tb)
        np.testing.assert_array_equal(meta[leaf] & 15, count[sl][leaf])
        np.testing.assert_array_equal(nodes[sl, 7], miss[sl] + nb)
        assert ((meta[leaf] >> 4) + (meta[leaf] & 15) <= tb + tc).all()
    tris = np.asarray(dev.kernel_tables.tris).reshape(-1, 9)
    np.testing.assert_array_equal(tris[:, 3:6], np.asarray(dev.bvh_tri_e1))


def test_pack_tables_rejects_wide_leaves():
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="leaf size"):
        bvh_kernel.pack_tables(z, z, [0], [16], [1], [(0, 1)], [(0, 16)],
                               np.zeros((16, 3)), np.zeros((16, 3)),
                               np.zeros((16, 3)), np.zeros((9, 16)))


@pytest.mark.parametrize("platform,want", [("gpu", "kernel"), ("cpu", "xla")])
def test_auto_traversal_follows_platform(platform, want):
    from raytpu.accel import resolve_traversal

    assert resolve_traversal("auto", platform) == want
    assert resolve_traversal("xla", platform) == "xla"
    assert resolve_traversal("kernel", platform) == "kernel"


def test_traversal_refuses_unknown_platform_and_names():
    from raytpu.accel import resolve_traversal

    with pytest.raises(ValueError, match="no traversal"):
        resolve_traversal("auto", "rocm")
    with pytest.raises(ValueError, match="unknown traversal"):
        resolve_traversal("mega", "gpu")


def test_tie_scene_kernel_matches_xla():
    """A tie-prone scene: two instances of the same cube at the identity
    transform — every triangle coincident across them — with different
    materials, so a tie broken differently becomes a visible pixel. Both
    walks visit instances in the same order and keep the first of equal
    hits, so the frames agree."""
    from raytpu.io.genmesh import GENERATED as g

    cfg = RenderConfig(
        objects=(ObjectConfig(g + "cube", MaterialType.MIRROR, "static"),
                 ObjectConfig(g + "cube", MaterialType.DIFFUSE, "static")),
        skybox_dir=g + "skybox_sea", skybox_size=64,
        width=32, height=24, samples_per_pixel=2, max_bounce_count=2,
    )
    r = Renderer(load_scene(cfg))
    r.set_transforms(0.0)
    img_xla = r.render_np()
    r.static = dataclasses.replace(r.static, traversal="kernel",
                                   interpret=True)
    np.testing.assert_allclose(r.render_np(), img_xla, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "anyhit"])
def test_compiled_kernel_matches_packet_walk(mode):
    """On the card: the compiled kernel against the XLA walk on 64k rays
    of a 20k-triangle mesh, including a ragged tail and dead lanes."""
    r = Renderer(load_scene(
        RenderConfig(objects=(ObjectConfig("ball", MaterialType.DIFFUSE),
                              ObjectConfig("box", MaterialType.MIRROR,
                                           "orbit")),
                     width=8, height=8),
        meshes=[generate_highpoly(depth=5), cube()],
        skybox=np.full((6, 4, 4, 3), 0.5, np.float32)))
    r.set_transforms(0.3)
    assert r.static.traversal == "kernel"
    o, d, tmax = _rays(65536 - 37, 0.2)
    o_pk = tuple(jnp.asarray(o[None, :, c]) for c in range(3))
    d_pk = tuple(jnp.asarray(d[None, :, c]) for c in range(3))
    win = jnp.asarray(tmax[None])
    xla = dataclasses.replace(r.static, traversal="xla")
    if mode == "closest":
        got = trace.closest_hit_wave(r.device_scene, r.static, o_pk, d_pk,
                                     TMIN, win)
        ref = trace.closest_hit_wave(r.device_scene, xla, o_pk, d_pk,
                                     TMIN, win)
        valid = np.asarray(ref.valid)
        assert (np.asarray(got.valid) != valid).mean() < 1e-3
        assert (np.asarray(got.prim) != np.asarray(ref.prim)).mean() < 1e-3
        both = valid & np.asarray(got.valid)
        np.testing.assert_allclose(np.asarray(got.t)[both],
                                   np.asarray(ref.t)[both], rtol=1e-4)
    else:
        got = np.asarray(trace.any_hit_wave(r.device_scene, r.static, o_pk,
                                            d_pk, TMIN, win))
        ref = np.asarray(trace.any_hit_wave(r.device_scene, xla, o_pk, d_pk,
                                            TMIN, win))
        assert (got != ref).mean() < 1e-3
