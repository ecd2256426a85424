"""Multi-device tile-sharded rendering on the 8-device CPU mesh.

The "multi-node without a real cluster" test (SURVEY.md §4): conftest forces
8 virtual CPU devices; sharded output must equal the single-device render.
"""

import jax
import numpy as np
import pytest

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.integrator import render_frame
from raytpu.io.genmesh import load_mesh
from raytpu.parallel import make_mesh, render_sharded
from raytpu.render import Renderer
from raytpu.scene import load_scene


@pytest.fixture(scope="module")
def small_scene(resources_dir):
    res = resources_dir
    sky = np.zeros((6, 4, 4, 3), np.float32)
    sky[:] = np.asarray([0.3, 0.5, 0.7], np.float32)
    cfg = RenderConfig(
        objects=(
            ObjectConfig(f"{res}/cube.obj", MaterialType.MIRROR, "static"),
            ObjectConfig(f"{res}/cube.obj", MaterialType.DIFFUSE, "orbit"),
        ),
        width=32,
        height=24,
        samples_per_pixel=2,
        max_bounce_count=3,
    )
    meshes = [load_mesh(o.path) for o in cfg.objects]
    scene = load_scene(cfg, meshes=meshes, skybox=sky)
    r = Renderer(scene)
    r.set_transforms(0.25)
    return r


def test_eight_virtual_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(small_scene):
    r = small_scene
    img_single = np.asarray(
        render_frame(r.device_scene, r.static, r.render_static, r.camera.basis())
    )
    mesh = make_mesh(8)
    img_sharded = np.asarray(
        render_sharded(r.device_scene, r.static, r.render_static,
                       r.camera.basis(), mesh)
    )
    assert img_sharded.shape == img_single.shape
    # the sharded path runs the SAME tile-major packet pipeline per shard,
    # so the output is bit-identical, not just close
    np.testing.assert_array_equal(img_sharded, img_single)


def test_sharded_hits_pallas_when_forced(small_scene):
    """Forcing the traversal kernel (Pallas interpreter here) keeps the
    sharded path on the kernel: each shard's padded local wave goes
    through the kernel and the frame matches the single-device one."""
    import dataclasses

    r = small_scene
    static_forced = dataclasses.replace(r.static, traversal="kernel",
                                        interpret=True)
    mesh = make_mesh(2)
    img = np.asarray(
        render_sharded(r.device_scene, static_forced, r.render_static,
                       r.camera.basis(), mesh)
    )
    img_single = np.asarray(
        render_frame(r.device_scene, static_forced, r.render_static,
                     r.camera.basis())
    )
    np.testing.assert_array_equal(img, img_single)


def test_sharded_nondivisible_rows(small_scene):
    # height 24 with 5 devices → padding path
    r = small_scene
    mesh = make_mesh(4)
    img = np.asarray(
        render_sharded(r.device_scene, r.static, r.render_static,
                       r.camera.basis(), mesh)
    )
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


def test_sharded_output_actually_distributed(small_scene):
    r = small_scene
    mesh = make_mesh(8)
    img = render_sharded(
        r.device_scene, r.static, r.render_static, r.camera.basis(), mesh
    )
    # the device buffer should be sharded across all 8 devices
    assert len(img.sharding.device_set) == 8


def test_sharded_config2_class_resolution(resources_dir):
    """Config2-class sharded render (teapot mirror + skybox, 256×192, 4spp,
    2-bounce) — realistic tile-row padding / packet-granule interactions
    (height 192 = 6 tile rows over 8 devices → non-divisible shard heights),
    asserting bit-identity vs single device."""
    res = resources_dir
    from raytpu.io.image import load_skybox

    cfg = RenderConfig(
        objects=(
            ObjectConfig(f"{res}/teapot.obj", MaterialType.MIRROR, "spin"),
        ),
        width=256,
        height=192,
        samples_per_pixel=4,
        max_bounce_count=2,
        skybox_dir=f"{res}/skybox_texture_sea",
    )
    meshes = [load_mesh(o.path) for o in cfg.objects]
    sky = load_skybox(cfg.skybox_dir)
    scene = load_scene(cfg, meshes=meshes, skybox=sky)
    r = Renderer(scene)
    r.set_transforms(0.5)
    img_single = np.asarray(
        render_frame(r.device_scene, r.static, r.render_static,
                     r.camera.basis())
    )
    mesh = make_mesh(8)
    img_sharded = np.asarray(
        render_sharded(r.device_scene, r.static, r.render_static,
                       r.camera.basis(), mesh)
    )
    assert img_sharded.shape == (192, 256, 3)
    np.testing.assert_array_equal(img_sharded, img_single)


def test_renderer_devices_config(small_scene):
    """config.devices>1 routes Renderer.render through the sharded path and
    matches the single-device image."""
    from raytpu.render import Renderer

    r1 = small_scene
    img_single = r1.render_np()
    scene2 = r1.scene
    scene2.config = scene2.config.replace(devices=8)
    r8 = Renderer(scene2)
    r8.set_transforms(0.25)
    img_multi = r8.render_np()
    np.testing.assert_allclose(img_multi, img_single, atol=1e-6)
    scene2.config = scene2.config.replace(devices=1)


@pytest.mark.gpu
def test_sharded_matches_single_device_on_gpu():
    """On the card: the sharded frame over every visible GPU equals the
    single-device frame, with the traversal kernel compiled (on a one-card
    machine the mesh has one device, which still runs dist.py's padding
    and per-shard path)."""
    import dataclasses

    from raytpu.presets import load_preset_scene, PRESETS

    cfg = PRESETS["config2"]().replace(width=256, height=192,
                                       skybox_size=256)
    r = Renderer(load_preset_scene(cfg))
    r.set_transforms(0.5)
    assert r.static.traversal == "kernel"
    img_single = np.asarray(
        render_frame(r.device_scene, r.static, r.render_static,
                     r.camera.basis()))
    mesh = make_mesh(len(jax.devices()))
    img_sharded = np.asarray(
        render_sharded(r.device_scene, r.static, r.render_static,
                       r.camera.basis(), mesh))
    np.testing.assert_array_equal(img_sharded, img_single)


def test_sharded_bench_mode(resources_dir):
    """The multi-device bench entry (`run_benchmark(devices=N)`) runs on a
    CPU mesh: shards the frame over all 8 virtual devices and reports the
    devices it ran on."""
    res = resources_dir
    from raytpu.bench import run_benchmark

    cfg = RenderConfig(
        objects=(
            ObjectConfig(f"{res}/cube.obj", MaterialType.MIRROR, "static"),
        ),
        skybox_dir=f"{res}/skybox_texture_sea",
        width=64, height=64, samples_per_pixel=1, max_bounce_count=1,
    )
    r = run_benchmark(preset=cfg, frames=2, count=False, devices=8)
    assert r["devices"] == 8
    assert r["platform"] == "cpu" and r["count"] == 8
    assert r["frame_ms"] > 0 and r["fps"] > 0
