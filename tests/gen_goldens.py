"""Generate the in-repo golden images (tests/goldens/*.npz).

Run manually (NOT collected by pytest):

    JAX_PLATFORMS=cpu python -m tests.gen_goldens

Each golden is rendered by the vectorized float64 oracle
(``tests/oracle_vec.py``, pinned to the scalar oracle by
``tests/test_oracle_vec.py``) at 128² over the in-repo stand-in assets
(``raytpu/io/genmesh.py``) — big enough that a normal-transform or TIR
regression shifts SSIM, small enough to live in-repo (~100 KB each).
``tests/test_goldens.py`` compares raytpu renders against these files.
"""

from __future__ import annotations

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SIZE = 128


def golden_cases():
    """(name, objects, bounces, spp) — config2/config3/config4-class scenes
    over the stand-ins (cube_scene for refraction, teapot for the mirror +
    curved normals)."""
    from raytpu.config import MaterialType, ObjectConfig
    from raytpu.io.genmesh import GENERATED as g

    return [
        (
            "teapot_mirror",
            [ObjectConfig(g + "teapot", MaterialType.MIRROR, "static")],
            2, 1,
        ),
        (
            "cube_scene_refract",
            [ObjectConfig(g + "cube_scene", MaterialType.REFRACTIVE,
                          "static")],
            3, 1,
        ),
        (
            "teapot_mirror_cube_diffuse",
            [
                ObjectConfig(g + "teapot", MaterialType.MIRROR, "static"),
                ObjectConfig(g + "cube", MaterialType.DIFFUSE, "orbit"),
            ],
            3, 1,
        ),
    ]


def build_case(objs, bounces, spp):
    import jax.numpy as jnp

    from raytpu.ops.sky import sample_cubemap
    from tests import oracle_vec
    from tests.test_integrator import (
        _camera_tuple,
        _gradient_skybox,
        _scene_and_oracle,
    )

    renderer, osc, cfg = _scene_and_oracle(
        None, objs, spp=spp, max_bounces=bounces, size=SIZE
    )
    sky = jnp.asarray(_gradient_skybox(8))

    def batched_sky(dirs):
        return np.asarray(
            sample_cubemap(sky, jnp.asarray(dirs, jnp.float32))
        ).astype(float)

    vs = oracle_vec.VecScene(
        osc.instances, osc.light_pos, osc.light_intensity, batched_sky
    )
    return renderer, vs, _camera_tuple(renderer)


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    from tests import oracle_vec

    for name, objs, bounces, spp in golden_cases():
        _, vs, cam = build_case(objs, bounces, spp)
        img = oracle_vec.render(vs, cam, SIZE, SIZE, spp, bounces)
        path = os.path.join(GOLDEN_DIR, f"{name}_{SIZE}.npz")
        np.savez_compressed(path, image=img.astype(np.float32))
        print(f"{path}: mean={img.mean():.4f} max={img.max():.4f}")


if __name__ == "__main__":
    main()
