"""Cubemap sampler tests (GL major-axis semantics, src/main.cpp:2376-2412)."""

import numpy as np
import jax.numpy as jnp

from raytpu.ops.sky import cube_face_st, sample_cubemap


def _distinct_faces(size=8):
    """Each face a distinct constant color."""
    colors = np.eye(3, dtype=np.float32)
    colors = np.concatenate([colors, 1 - colors], axis=0)  # 6 distinct rgb
    sky = np.zeros((6, size, size, 3), np.float32)
    for f in range(6):
        sky[f] = colors[f]
    return jnp.asarray(sky), colors


def test_major_axis_face_selection():
    dirs = jnp.asarray(
        [
            [1, 0.1, 0.1],   # +X
            [-1, 0.1, 0.1],  # -X
            [0.1, 1, 0.1],   # +Y
            [0.1, -1, 0.1],  # -Y
            [0.1, 0.1, 1],   # +Z
            [0.1, 0.1, -1],  # -Z
        ],
        jnp.float32,
    )
    face, s, t = cube_face_st(dirs)
    np.testing.assert_array_equal(np.asarray(face), [0, 1, 2, 3, 4, 5])
    assert np.all((np.asarray(s) >= 0) & (np.asarray(s) <= 1))
    assert np.all((np.asarray(t) >= 0) & (np.asarray(t) <= 1))


def test_face_centers_map_to_center_texel():
    dirs = jnp.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.float32,
    )
    _, s, t = cube_face_st(dirs)
    np.testing.assert_allclose(np.asarray(s), 0.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t), 0.5, atol=1e-6)


def test_sample_constant_faces():
    sky, colors = _distinct_faces()
    dirs = jnp.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.float32,
    )
    out = np.asarray(sample_cubemap(sky, dirs))
    np.testing.assert_allclose(out, colors, atol=1e-6)


def test_st_orientation_plus_x():
    # GL table: +X face has sc=-z, tc=-y. Direction (1, -0.5, -0.5):
    # sc = 0.5 → s = 0.75; tc = 0.5 → t = 0.75 (right of center, below center)
    face, s, t = cube_face_st(jnp.asarray([[1.0, -0.5, -0.5]]))
    assert int(face[0]) == 0
    np.testing.assert_allclose(float(s[0]), 0.75, atol=1e-6)
    np.testing.assert_allclose(float(t[0]), 0.75, atol=1e-6)


def test_bilinear_interpolates():
    # 2×2 face: +Z face gradient; sample between texels
    sky = np.zeros((6, 2, 2, 3), np.float32)
    sky[4, 0, 0] = [0, 0, 0]
    sky[4, 0, 1] = [1, 1, 1]
    sky[4, 1, 0] = [1, 1, 1]
    sky[4, 1, 1] = [0, 0, 0]
    out = np.asarray(sample_cubemap(jnp.asarray(sky), jnp.asarray([[0.0, 0.0, 1.0]])))
    np.testing.assert_allclose(out[0], [0.5, 0.5, 0.5], atol=1e-6)


def test_clamp_to_edge_at_corners():
    sky, colors = _distinct_faces(size=4)
    # direction pointing at the very corner of the +X face: must not wrap/NaN
    out = np.asarray(
        sample_cubemap(sky, jnp.asarray([[1.0, 0.999, 0.999], [1.0, -0.999, -0.999]]))
    )
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, [colors[0], colors[0]], atol=1e-5)


def test_scale_invariance():
    sky, _ = _distinct_faces()
    d = jnp.asarray([[0.3, 0.2, 0.9]])
    a = np.asarray(sample_cubemap(sky, d))
    b = np.asarray(sample_cubemap(sky, d * 7.5))
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_bilinear2x_close_to_bilinear(rng):
    """Single-tap into the 2x-prefiltered map ~ true bilinear (quarter-texel
    max error) on a smooth cube map."""
    import jax.numpy as jnp
    from raytpu.device_scene import build_device_scene
    from raytpu.config import MaterialType, ObjectConfig, RenderConfig
    from raytpu.io.obj import Mesh
    from raytpu.scene import load_scene
    from raytpu.ops.sky import sample_cubemap_u32, sample_cubemap_u32_nearest

    size = 32
    g = np.linspace(0, 1, size, dtype=np.float32)
    face = np.stack(list(np.meshgrid(g, g, indexing="ij")) + [np.full((size, size), 0.5, np.float32)], -1)
    sky = np.stack([face] * 6, 0).astype(np.float32)

    tri = Mesh(
        positions=np.zeros((3, 3), np.float32),
        normals=np.zeros((3, 3), np.float32),
        triangles=np.array([[0, 1, 2]], np.int32), name="t",
    )
    cfg = RenderConfig(objects=(ObjectConfig("t", MaterialType.DIFFUSE),),
                       skybox_filter="bilinear2x")
    dev, _ = build_device_scene(load_scene(cfg, meshes=[tri], skybox=sky))

    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = tuple(jnp.asarray(d[:, c]) for c in range(3))
    exact = sample_cubemap_u32(dev.skybox_u32, size, size, dirs)
    fast = sample_cubemap_u32_nearest(dev.skybox_u32_2x, 2 * size, 2 * size, dirs)
    for c in range(3):
        err = np.abs(np.asarray(exact[c]) - np.asarray(fast[c]))
        # quarter-texel of a smooth gradient + 8-bit quantization
        assert err.max() < 0.02, err.max()


def test_generated_skybox_faces_meet_without_seams():
    """The stand-in sky is a function of direction, so the bilinear sampler
    reads the same colour on both sides of every face edge."""
    from raytpu.io.genmesh import skybox_sea
    from raytpu.ops.sky import sample_cubemap

    sky = jnp.asarray(skybox_sea(64, seed=3))
    rng = np.random.RandomState(1)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # push directions onto the diagonal planes where two faces meet, then
    # nudge them a little to each side
    a = np.abs(d)
    major = np.argmax(a, axis=1)
    second = np.argsort(a, axis=1)[:, 1]
    edge = d.copy()
    edge[np.arange(len(d)), second] = (np.sign(d[np.arange(len(d)), second])
                                       * a[np.arange(len(d)), major])
    eps = 2e-3
    lo, hi = edge.copy(), edge.copy()
    lo[np.arange(len(d)), second] *= 1 - eps
    hi[np.arange(len(d)), second] *= 1 + eps
    c_lo = np.asarray(sample_cubemap(sky, jnp.asarray(lo)))
    c_hi = np.asarray(sample_cubemap(sky, jnp.asarray(hi)))
    assert np.abs(c_lo - c_hi).max() < 0.06


def test_device_scene_packs_skybox_texels():
    """build_device_scene packs each texel's 8-bit RGB into one word."""
    from raytpu.device_scene import build_device_scene
    from raytpu.config import MaterialType, ObjectConfig, RenderConfig
    from raytpu.io.obj import Mesh
    from raytpu.scene import load_scene

    size = 8
    rng = np.random.RandomState(5)
    sky = rng.rand(6, size, size, 3).astype(np.float32)
    tri = Mesh(
        positions=np.zeros((3, 3), np.float32),
        normals=np.zeros((3, 3), np.float32),
        triangles=np.array([[0, 1, 2]], np.int32), name="t",
    )
    cfg = RenderConfig(objects=(ObjectConfig("t", MaterialType.DIFFUSE),))
    dev, static = build_device_scene(load_scene(cfg, meshes=[tri], skybox=sky))
    assert static.sky_hw == (size, size)
    packed = np.asarray(dev.skybox_u32).reshape(6, size, size)
    want = np.clip(sky * 255.0 + 0.5, 0, 255).astype(np.uint32)
    for c, sh in enumerate((0, 8, 16)):
        assert np.array_equal((packed >> sh) & 0xFF, want[..., c])
