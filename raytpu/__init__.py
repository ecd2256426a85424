"""raytpu — a real-time Whitted ray tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``mcan1999/vulkan-raytracing`` (a Vulkan ``VK_KHR_ray_tracing_pipeline``
renderer): OBJ scenes with diffuse / mirror / refractive materials, hard
shadows from a point light, cubemap skybox, multi-sample jittered primary
rays, iterative multi-bounce reflection/refraction, fly camera, animated
instances, and interactive/headless frontends. It runs on an NVIDIA GPU
(and on the CPU for tests).

Architecture (not a port — the GPU here has no ray-tracing units to hand
the traversal to):

* the Vulkan RT pipeline (TLAS/BLAS + rgen/rchit/rmiss shaders) becomes an
  **LBVH/SAH BVH builder** + **stackless traversal** over a skip-link
  ("threaded") BVH layout: a per-ray Pallas kernel on the GPU
  (``ops/bvh_kernel.py``), an XLA packet walk elsewhere;
* the per-pixel bounce loop in the raygen shader (``src/shader.rgen:84``)
  becomes a **wavefront integrator**: SoA ray batches, masked material
  branches, `lax.while_loop` bounces;
* per-frame TLAS refit becomes simply passing new instance transforms into
  the jitted ``render`` — transforms are inputs, not rebuilt structures;
* multi-device scaling shards pixel tiles over a `jax.sharding.Mesh`
  (`raytpu.parallel`), with the scene replicated per device.
"""

from raytpu.config import (
    MaterialType,
    ObjectConfig,
    RenderConfig,
    reference_default,
)
from raytpu.camera import Camera, MoveDirection
from raytpu.scene import Scene, load_scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "MaterialType",
    "MoveDirection",
    "ObjectConfig",
    "RenderConfig",
    "Scene",
    "load_scene",
    "reference_default",
]
