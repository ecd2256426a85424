"""Whitted integrator golden tests vs the independent NumPy oracle.

This is the BASELINE config-1 style check (cube scene, primary + shadows) at
CPU-checkable resolution, plus mirror/refractive coverage — the vectorized
JAX integrator and the scalar oracle implement the reference semantics
independently and must agree pixel-for-pixel (up to float tolerance).
"""

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.integrator import RenderStatic, hash_random, render_frame
from raytpu.io.genmesh import load_mesh
from raytpu.render import Renderer
from raytpu.scene import load_scene

from tests import oracle


SKY_TOP = np.array([0.2, 0.4, 0.9], np.float32)
SKY_BOT = np.array([0.9, 0.6, 0.2], np.float32)


def _gradient_skybox(size=8):
    """Vertical-gradient skybox, analytically samplable by the oracle."""
    sky = np.zeros((6, size, size, 3), np.float32)
    # faces 2 (+Y) and 3 (-Y): constant top/bottom colors
    sky[2] = SKY_TOP
    sky[3] = SKY_BOT
    # side faces: rows blend top->bottom (t=0 row is toward +Y for sides)
    rows = np.linspace(0, 1, size, dtype=np.float32)[:, None]
    side = SKY_TOP[None, None] * (1 - rows[..., None]) + SKY_BOT[None, None] * rows[..., None]
    for f in (0, 1, 4, 5):
        sky[f] = np.broadcast_to(side, (size, size, 3))
    return sky


def _oracle_skybox_fn(sky):
    import jax.numpy as jnp
    from raytpu.ops.sky import sample_cubemap

    def fn(d):
        return np.asarray(
            sample_cubemap(jnp.asarray(sky), jnp.asarray(d, jnp.float32)[None])
        )[0]

    return fn


def _scene_and_oracle(resources_dir, objects, spp=1, max_bounces=3, size=24,
                      sky_size=8):
    sky = _gradient_skybox(sky_size)
    cfg = RenderConfig(
        objects=tuple(objects),
        width=size,
        height=size,
        samples_per_pixel=spp,
        max_bounce_count=max_bounces,
        skybox_filter="bilinear",  # the oracle implements exact bilinear
    )
    meshes = [load_mesh(o.path) for o in objects]
    scene = load_scene(cfg, meshes=meshes, skybox=sky)
    renderer = Renderer(scene)
    renderer.set_transforms(0.0)

    anim = scene.animation()
    anim.step(0.0)
    o2w = anim.transforms_3x4()
    instances = []
    for i, (mesh, inst) in enumerate(zip(meshes, scene.instances)):
        m4 = np.eye(4)
        m4[:3] = o2w[i]
        instances.append(
            dict(
                verts=mesh.positions.astype(float),
                normals=mesh.normals.astype(float),
                tris=mesh.triangles,
                material=int(inst.material),
                o2w=m4,
                w2o=np.linalg.inv(m4),
            )
        )
    osc = oracle.OracleScene(
        instances,
        cfg.light_position,
        cfg.light_intensity,
        _oracle_skybox_fn(sky),
    )
    return renderer, osc, cfg


def _camera_tuple(renderer):
    b = renderer.camera.basis().astype(float)
    return (b[0], b[1], b[2], b[3])


def test_hash_random_matches_oracle():
    pix = jnp.asarray([[3.0, 7.0], [100.0, 200.0], [0.0, 0.0]])
    for seed in (4.0, 4.5, 9.0):
        ours = np.asarray(hash_random(pix, jnp.float32(seed)))
        theirs = [oracle.hash_random(float(p[0]), float(p[1]), seed) for p in pix]
        # both are float32; sin implementations differ by ulps which the
        # fract(sin·43758) construction amplifies — ~1e-2 is the match class
        np.testing.assert_allclose(ours, theirs, atol=2e-2)


@pytest.mark.parametrize("material", [MaterialType.DIFFUSE, MaterialType.MIRROR,
                                      MaterialType.REFRACTIVE])
def test_cube_golden_vs_oracle(resources_dir, material):
    """Config-1 style golden: single cube, 24×24, 1 spp, vs the oracle."""
    renderer, osc, cfg = _scene_and_oracle(
        resources_dir,
        [ObjectConfig(f"{resources_dir}/cube.obj", material, "static")],
        spp=1,
        max_bounces=3,
        size=24,
    )
    img = renderer.render_np()
    ref = oracle.render(
        osc, _camera_tuple(renderer), cfg.width, cfg.height, 1, 3
    )
    # float32 vs float64 paths: allow small tolerance, no structural diffs
    bad = np.abs(img - ref) > 5e-3
    frac_bad = bad.any(axis=-1).mean()
    assert frac_bad < 0.04, f"{frac_bad:.3%} pixels differ (material={material})"


def test_two_instances_with_transform(resources_dir):
    """Two cubes (one orbiting → translated), mixed materials, with shadows."""
    renderer, osc, cfg = _scene_and_oracle(
        resources_dir,
        [
            ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.MIRROR, "static"),
            ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE, "orbit"),
        ],
        spp=2,
        max_bounces=4,
        size=16,
    )
    img = renderer.render_np()
    ref = oracle.render(osc, _camera_tuple(renderer), cfg.width, cfg.height, 2, 4)
    bad = (np.abs(img - ref) > 5e-3).any(axis=-1).mean()
    assert bad < 0.05, f"{bad:.3%} pixels differ"


def test_all_sky_when_no_geometry_in_view(resources_dir):
    """Camera looking away from the scene sees pure skybox."""
    renderer, osc, cfg = _scene_and_oracle(
        resources_dir,
        [ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE, "static")],
        spp=1,
        max_bounces=1,
        size=8,
    )
    from raytpu.camera import MoveDirection

    renderer.camera.look(MoveDirection.BACKWARD)  # +Z: cube is at origin behind
    img = renderer.render_np()
    # every pixel should be a skybox color (between SKY_BOT and SKY_TOP blend)
    assert img.min() >= min(SKY_TOP.min(), SKY_BOT.min()) - 1e-3
    assert np.isfinite(img).all()


def test_render_deterministic(resources_dir):
    renderer, _, _ = _scene_and_oracle(
        resources_dir,
        [ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE, "static")],
        spp=2, max_bounces=2, size=12,
    )
    a = renderer.render_np()
    b = renderer.render_np()
    np.testing.assert_array_equal(a, b)


def test_ray_chunking_equivalent(resources_dir):
    base, _, _ = _scene_and_oracle(
        resources_dir,
        [ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.MIRROR, "static")],
        spp=1, max_bounces=2, size=16,
    )
    img_full = base.render_np()
    base.render_static = RenderStatic(
        width=16, height=16, samples_per_pixel=1, max_bounce_count=2,
        ray_chunk=64, skybox_filter="bilinear",
    )
    img_chunked = base.render_np()
    np.testing.assert_allclose(img_full, img_chunked, atol=1e-6)


def test_kernel_traversal_matches_xla(resources_dir):
    """The whole frame through the GPU traversal kernel (run by the Pallas
    interpreter here) renders what the XLA packet walk renders — the
    dispatch plumbing, the in-kernel instance loop and the kernel's
    normal interpolation, end to end."""
    objects = [
        ObjectConfig(f"{resources_dir}/teapot.obj", MaterialType.MIRROR,
                     "spin"),
        ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE,
                     "orbit"),
    ]
    base, _, _ = _scene_and_oracle(resources_dir, objects, spp=2,
                                   max_bounces=2, size=16)
    assert base.static.traversal == "xla"
    img_xla = base.render_np()
    base.static = dataclasses.replace(base.static, traversal="kernel",
                                      interpret=True)
    np.testing.assert_allclose(base.render_np(), img_xla, atol=1e-5)


def test_validation_jit_guard_fires(resources_dir, monkeypatch, capsys):
    """RenderConfig.validation=True plants in-jit NaN guards that report
    through an ordered debug callback when non-finite state appears."""
    from raytpu.config import MaterialType, ObjectConfig
    from raytpu.utils import log as rlog

    errors = []
    monkeypatch.setattr(rlog, "error", lambda msg: errors.append(msg))

    objs = [ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE,
                         "static")]
    renderer, _, cfg = _scene_and_oracle(resources_dir, objs, spp=1,
                                         max_bounces=0, size=16)
    rs = dataclasses.replace(renderer.render_static, validation=True)
    cam = np.asarray(renderer.camera.basis())

    # clean camera: no reports
    img = render_frame(renderer.device_scene, renderer.static, rs,
                       jnp.asarray(cam))
    jax.block_until_ready(img)
    jax.effects_barrier()
    assert not errors

    # poisoned camera: the in-jit guard must fire
    bad = cam.copy()
    bad[3] = np.nan
    img = render_frame(renderer.device_scene, renderer.static, rs,
                       jnp.asarray(bad))
    jax.block_until_ready(img)
    jax.effects_barrier()
    assert errors and "non-finite" in errors[0]


def test_three_instance_scene_matches_oracle(resources_dir):
    """Instance-count scaling: the traversal layer iterates the instance
    list (inside the GPU kernel, or one walk each on the XLA path), so >2
    instances — beyond the reference's fixed two (include/config.h:6-16)
    — must shade correctly across all material types at once."""
    from raytpu.utils import ssim

    objs = [
        ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.DIFFUSE,
                     "static"),
        ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.MIRROR,
                     "orbit"),
        ObjectConfig(f"{resources_dir}/cube.obj", MaterialType.REFRACTIVE,
                     "spin"),
    ]
    renderer, osc, cfg = _scene_and_oracle(resources_dir, objs, spp=1,
                                           max_bounces=3, size=32)
    img = renderer.render_np()
    ref = oracle.render(osc, _camera_tuple(renderer), 32, 32, 1, 3)
    s = ssim(img, np.asarray(ref, np.float32), win=8)
    assert s > 0.98, f"3-instance SSIM {s:.4f}"


def test_compact_wavefront_bit_identical(resources_dir):
    """wavefront="compact" (live-first packet waves through the bounce
    loop) must be BIT-IDENTICAL to the full-width loop: per-lane results
    are permutation-invariant and the budget DIVIDES p, so waves are
    disjoint slices (a non-divisor budget's clamped tail wave would
    re-apply bounce_core to already-bounced live rows — an extra bounce,
    not a recompute; _wave_budget must never emit one). The frame is
    sized so the wave budget is a real subset (128 packets → budget 64).
    """
    from raytpu.integrator import PACKET_GRANULE, _wave_budget

    assert _wave_budget(128) == 64
    assert _wave_budget(64) == 0      # too small → compaction disabled
    # divisor invariant over every granule multiple p up to a big wave
    for p in range(PACKET_GRANULE, 16384 + 1, PACKET_GRANULE):
        b = _wave_budget(p)
        if b:
            assert p % b == 0 and b % PACKET_GRANULE == 0 and 2 * b <= p, p
    assert _wave_budget(320) == 64    # 128 (old ~p/4 round-up) doesn't
    assert _wave_budget(1920) == 384  # divide; the divisor rule does
    assert _wave_budget(8192) == 2048
    assert _wave_budget(2048) == 512
    sky = _gradient_skybox()
    cfg = RenderConfig(
        objects=(
            ObjectConfig(f"{resources_dir}/cube.obj",
                         MaterialType.MIRROR, "spin"),
            ObjectConfig(f"{resources_dir}/cube.obj",
                         MaterialType.DIFFUSE, "orbit"),
        ),
        width=512, height=256, samples_per_pixel=1, max_bounce_count=3,
    )
    meshes = [load_mesh(o.path) for o in cfg.objects]
    scene = load_scene(cfg, meshes=meshes, skybox=sky)
    r = Renderer(scene)
    r.set_transforms(0.3)
    imgs = {}
    for mode in ("full", "compact"):
        rs = dataclasses.replace(r.render_static, wavefront=mode)
        imgs[mode] = np.asarray(
            render_frame(r.device_scene, r.static, rs,
                         jnp.asarray(r.camera.basis()))
        )
    np.testing.assert_array_equal(imgs["compact"], imgs["full"])
