"""Benchmark-harness tests: device identity, ray counting, the frame timer.

Timings on the CPU mean nothing; these pin what the harness reports and
that it refuses to measure without a GPU.
"""


import numpy as np
import pytest

from raytpu import bench
from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.integrator import RenderStatic


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.require_gpu()


def test_device_info_names_the_device():
    info = bench.device_info()
    assert info == {"platform": "cpu", "kind": "cpu", "count": 8}


def test_raycount_key_covers_shapes_and_platform():
    rs = RenderStatic(width=64, height=48, samples_per_pixel=2,
                      max_bounce_count=3)
    k = bench._raycount_key("config2", rs, 7, "gpu")
    assert k == "config2:64x48:spp2:b3:d7:gpu"
    assert k != bench._raycount_key("config2", rs, 7, "cpu")


def test_raycount_sidecar_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "RAYCOUNT_SIDECAR", str(tmp_path / "rc.json"))
    assert bench._raycount_lookup("a") is None
    bench._raycount_store("a", 12)
    bench._raycount_store("b", 7)
    assert bench._raycount_lookup("a") == 12
    assert bench._raycount_lookup("b") == 7


def _cube_renderer(resources_dir, size=32, bounces=1):
    from raytpu.render import Renderer
    from raytpu.scene import load_scene

    cfg = RenderConfig(
        objects=(ObjectConfig(f"{resources_dir}/cube.obj",
                              MaterialType.DIFFUSE, "static"),),
        width=size, height=size, samples_per_pixel=1,
        max_bounce_count=bounces,
    )
    r = Renderer(load_scene(cfg, skybox=np.full((6, 4, 4, 3), 0.5,
                                                np.float32)))
    r.set_transforms(0.0)
    return r


def test_count_rays_primary_plus_shadow(resources_dir):
    """Every in-frame pixel traces one primary ray; each diffuse front-face
    hit adds one shadow ray, so the count lies between W·H and 2·W·H."""
    r = _cube_renderer(resources_dir, size=32, bounces=0)
    n = bench.count_rays_frame(r.device_scene, r.static, r.render_static,
                               r.camera.basis())
    assert 32 * 32 < n < 2 * 32 * 32


def test_run_benchmark_reports_device_and_walk(resources_dir):
    r = _cube_renderer(resources_dir)
    out = bench.run_benchmark(preset=r.scene.config, frames=2, count=False,
                              renderer=r, traversal="xla")
    assert out["traversal"] == "xla"
    assert out["platform"] == "cpu" and out["count"] == 8
    assert len(out["frame_times_ms"]) == 2
    assert out["frame_ms"] > 0 and out["compile_s"] > 0
    assert out["mrays_per_s"] is None


def test_bench_script_exits_nonzero_without_gpu():
    import bench as bench_script

    with pytest.raises(RuntimeError, match="no GPU"):
        bench_script.main(["--presets", "config1"])
