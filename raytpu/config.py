"""Runtime configuration for the raytpu renderer.

The equivalent of the reference's compile-time configuration header
(``include/config.h:4-27``): scene mesh selection, per-object material type,
skybox directory, camera speed/sensitivity, bounce count, samples-per-pixel and
debug toggles. The reference bakes these in as ``#define``s; here they form a
frozen dataclass so a scene is a *value* — hashable, jit-static where needed,
and overridable from the CLI (``raytpu/cli.py``).

Material type encoding matches ``include/config.h:9-16`` and the uniform
struct consumed by the raygen shader (``src/shader.rgen:34-41``):
0 = diffuse, 1 = mirror, 2 = refractive.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple


class MaterialType(enum.IntEnum):
    """Per-object material type (``include/config.h:9-16``)."""

    DIFFUSE = 0
    MIRROR = 1
    REFRACTIVE = 2


# Shading constants hard-coded in the reference raygen shader
# (``src/shader.rgen:51-55``). Kept as module-level constants because they are
# part of the *semantics* being reproduced, not user knobs.
INDEX_OF_REFRACTION = 1.52
AMBIENT_INTENSITY = (0.8, 0.8, 0.8)   # Iamb
DIFFUSE_COEFF = (0.2, 1.0, 0.2)       # kd
AMBIENT_COEFF = (0.1, 0.3, 0.1)       # ka
SPECULAR_COEFF = (0.8, 0.8, 0.8)      # ks
SPECULAR_EXPONENT = 100.0             # src/shader.rgen:126
FOCAL_LENGTH = 2.5                    # src/shader.rgen:79
RAY_TMIN = 1e-3                       # src/shader.rgen:87
RAY_TMAX = 1e4                        # src/shader.rgen:87
HIT_EPSILON = 1e-2                    # offset along normal, src/shader.rgen:107,136,158,164
SAMPLE_DECAY = 0.9                    # pow(0.9, sample_index) quirk, src/shader.rgen:128


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """One mesh instance in the scene.

    The reference supports exactly two objects — a "center" mesh and an
    "orbiting" mesh (``include/config.h:6-7``) with animated instance
    transforms (``src/main.cpp:2836-2844``). raytpu generalises to N objects;
    ``animation`` selects the built-in transform track.
    """

    path: str
    material: MaterialType = MaterialType.DIFFUSE
    # Built-in animation tracks mirroring src/main.cpp:2836-2844:
    #  "static"  — identity transform
    #  "spin"    — accumulate slow Y-rotation per frame (center mesh)
    #  "orbit"   — circle of radius 10 about (0, 0, -5) (orbiting mesh)
    animation: str = "static"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full renderer configuration (reference: ``include/config.h`` +
    hard-coded values in ``src/main.cpp:805,1847-1873``)."""

    # --- scene (config.h:4-17) ---
    objects: Tuple[ObjectConfig, ...] = ()
    skybox_dir: Optional[str] = None          # SKYBOX_TEXTURE_DIR
    skybox_size: int = 2048                   # generated skybox face size

    # --- camera (config.h:18-19; initial pose src/main.cpp:1848-1851) ---
    camera_position: Tuple[float, float, float] = (0.0, 0.0, 20.0)
    camera_mouse_sensitivity: float = 0.0005
    camera_speed: float = 50.0

    # --- lighting (src/main.cpp:1853-1854) ---
    light_position: Tuple[float, float, float] = (5.0, 5.0, 5.0)
    light_intensity: float = 1.0

    # --- integrator (config.h:26-27) ---
    max_bounce_count: int = 63
    samples_per_pixel: int = 4

    # --- framebuffer (src/main.cpp:805) ---
    width: int = 800
    height: int = 600

    # --- debug / perf toggles (config.h:21-24) ---
    test_fps: bool = False                    # uncapped frame loop + FPS print
    validation: bool = False                  # NaN/finite guards on the render path

    # skybox filter: "bilinear" (default: the reference's LINEAR-sampler
    # semantics, 4 gathers), "bilinear2x" (one gather into a 2x-prefiltered
    # map — max quarter-texel error vs true bilinear), "nearest" (1 gather,
    # unfiltered)
    skybox_filter: str = "bilinear"

    # --- renderer knobs (no reference analog) ---
    # bounce-loop scheduling: "full" runs every loop iteration at frame
    # width; "compact" sorts packets live-first after the (peeled) primary
    # bounce and runs later iterations over ~P/4-packet waves — packet
    # moves are contiguous row copies, and the elementwise shading and the
    # sweeps shrink with the wave. Bit-identical (per-lane results are
    # permutation-invariant). The default was chosen before the move to the
    # GPU and has not been re-measured there.
    wavefront: str = "compact"
    ray_chunk: int = 0            # rays per traversal chunk; 0 = whole frame
    # max triangles per BVH leaf. 12 was chosen before the move to the GPU
    # and has not been re-measured there; RAYTPU_LEAF_SIZE overrides BOTH
    # this and the traversal unroll (ops/intersect.LEAF_UNROLL) so they
    # stay consistent
    leaf_size: int = int(os.environ.get("RAYTPU_LEAF_SIZE", "12"))
    bvh_builder: str = "auto"     # "auto" | "native" | "sah" | "median" | "lbvh"
    # "auto" (the GPU kernel on a GPU, the XLA packet walk on the CPU) |
    # "kernel" | "xla" | "brute" — see accel.resolve_traversal
    traversal: str = "auto"
    dtype: str = "float32"
    devices: int = 1              # pixel-tile sharding degree (parallel/dist.py)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def primary_rays_per_frame(self) -> int:
        return self.num_pixels * self.samples_per_pixel

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def reference_default(resource_dir: str = "resources") -> RenderConfig:
    """The reference's default compile-time scene (``include/config.h:4-16``):
    mirror teapot (center) + diffuse armadillo (orbiting), sea skybox.

    ``armadillo.obj`` is a missing large blob in the reference mount
    (``/root/reference/.MISSING_LARGE_BLOBS:1``); callers should substitute a
    stand-in high-poly mesh (see ``raytpu/io/genmesh.py``).
    """
    return RenderConfig(
        objects=(
            ObjectConfig(f"{resource_dir}/teapot.obj", MaterialType.MIRROR, "spin"),
            ObjectConfig(f"{resource_dir}/armadillo.obj", MaterialType.DIFFUSE, "orbit"),
        ),
        skybox_dir=f"{resource_dir}/skybox_texture_sea",
    )
