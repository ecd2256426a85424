"""Device-resident scene: the pytree consumed by the jitted render step.

The analog of the reference's descriptor-set ABI
(``src/main.cpp:1305-1351``): binding 0 (TLAS) → per-instance transforms +
per-mesh BVH arrays; bindings 2/3 (index/vertex SSBOs) → pre-gathered
per-triangle corner data; binding 5 (cubemap sampler) → the skybox array;
binding 1 (UBO) → light/material scalars.

Layout choices:

* **pre-gathered corner SoA**: instead of the reference's index buffer +
  interleaved vertex buffer chased at hit time (``src/shader.rchit:62-86``),
  we store per-triangle ``v0/e1/e2`` (intersection) and ``n0/n1/n2``
  (shading) directly. One gather by primitive id replaces three dependent
  gathers.
* **object space + transforms as inputs**: triangles stay in object space;
  instance transforms are ordinary jit inputs. Per-frame "TLAS refit"
  (``src/main.cpp:606-608,730-778``) is therefore free — no rebuild, no
  fence, no allocation.
* geometry of all meshes is concatenated; per-mesh primitive ranges live in
  the hashable :class:`SceneStatic` so slicing is static under jit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from raytpu.scene import Scene


class DeviceScene(NamedTuple):
    """All dynamic (traced) scene arrays. A plain pytree."""

    # per-triangle corner data, concatenated over meshes (object space)
    tri_v0: jnp.ndarray  # (T, 3) float32
    tri_e1: jnp.ndarray  # (T, 3)
    tri_e2: jnp.ndarray  # (T, 3)
    tri_n0: jnp.ndarray  # (T, 3) corner vertex normals
    tri_n1: jnp.ndarray  # (T, 3)
    tri_n2: jnp.ndarray  # (T, 3)

    # per-instance state (updated every frame by animation; "TLAS refit")
    o2w: jnp.ndarray        # (N, 3, 4) object→world
    w2o: jnp.ndarray        # (N, 3, 4) world→object
    materials: jnp.ndarray  # (N,) int32 (0 diffuse / 1 mirror / 2 refract)

    # environment + lighting (UBO analog, src/main.cpp:1847-1873); the
    # float skybox stays HOST-side — the device carries only the packed
    # uint32 maps below (the float (6,H,W,3) + SoA planes were ~600MB of
    # dead HBM at reference resolution). Face dims live in SceneStatic.
    light_pos: jnp.ndarray        # (3,)
    light_intensity: jnp.ndarray  # () scalar

    # component-SoA shading-normal tables (see ops/vec3.py)
    tri_n_soa: Optional[jnp.ndarray] = None    # (9, T): n0x n0y n0z n1x ... n2z
    # skybox packed RGB8 into one uint32 word per texel: one gather per
    # bilinear tap instead of three
    skybox_u32: Optional[jnp.ndarray] = None   # (6*H*W,) uint32
    # 2x bilinear-prefiltered packed map: single-tap sampling with at most
    # a quarter-texel error vs true bilinear; built only for
    # skybox_filter="bilinear2x"
    skybox_u32_2x: Optional[jnp.ndarray] = None  # (6*2H*2W,) uint32

    # acceleration structure arrays (None until attached by raytpu.accel):
    # threaded (skip-link) BVH, concatenated over meshes
    bvh_aabb_min: Optional[jnp.ndarray] = None  # (M, 3) float32
    bvh_aabb_max: Optional[jnp.ndarray] = None  # (M, 3)
    bvh_tri_first: Optional[jnp.ndarray] = None  # (M,) int32, -1 for inner
    bvh_tri_count: Optional[jnp.ndarray] = None  # (M,) int32
    bvh_miss: Optional[jnp.ndarray] = None       # (M,) int32 skip link
    # triangle data permuted into BVH-leaf order (locality), with a map
    # back to original primitive ids for attribute fetch
    bvh_tri_v0: Optional[jnp.ndarray] = None   # (T, 3)
    bvh_tri_e1: Optional[jnp.ndarray] = None
    bvh_tri_e2: Optional[jnp.ndarray] = None
    bvh_tri_prim: Optional[jnp.ndarray] = None  # (T,) int32 → global prim id

    # the same BVH in the GPU traversal kernel's record layout
    # (ops/bvh_kernel.pack_tables); None off the kernel path
    kernel_tables: Optional[object] = None

    def with_transforms(
        self, o2w: np.ndarray, w2o: np.ndarray
    ) -> "DeviceScene":
        """Per-frame instance transform update (the refit analog)."""
        return self._replace(
            o2w=jnp.asarray(o2w, jnp.float32), w2o=jnp.asarray(w2o, jnp.float32)
        )


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static scene metadata (a jit static argument)."""

    # per-mesh (start, count) into the concatenated triangle arrays
    mesh_prim_ranges: Tuple[Tuple[int, int], ...]
    # per-instance mesh id
    instance_mesh: Tuple[int, ...]
    # per-mesh (start, count) into the concatenated BVH node arrays
    # (empty until a BVH is attached)
    mesh_node_ranges: Tuple[Tuple[int, int], ...] = ()
    # per-mesh (start, count) into the BVH-ordered triangle arrays
    mesh_bvh_tri_ranges: Tuple[Tuple[int, int], ...] = ()
    # traversal walk, resolved at BVH attach (accel.resolve_traversal):
    # "kernel" (GPU kernel) | "xla" (packet walk) | "brute" (no BVH)
    traversal: str = "brute"
    # run the traversal kernel through the Pallas interpreter (tests only)
    interpret: bool = False
    # skybox face dimensions (H, W) — the float cube map itself is host-only
    sky_hw: Tuple[int, int] = (1, 1)

    @property
    def traversal_list(self) -> Tuple[Tuple[int, int], ...]:
        """(instance id, mesh id) pairs in visit order."""
        return tuple(enumerate(self.instance_mesh))

    @property
    def num_instances(self) -> int:
        return len(self.instance_mesh)

    @property
    def has_bvh(self) -> bool:
        return len(self.mesh_node_ranges) > 0


def build_device_scene(scene: Scene) -> Tuple[DeviceScene, SceneStatic]:
    """Host :class:`raytpu.scene.Scene` → device pytree + static metadata.

    The corner pre-gather here performs, once at load time, the index-buffer
    chase the reference's hit shader performs per ray
    (``src/shader.rchit:62-86``).
    """
    g = scene.geometry
    tri = g.triangles.astype(np.int64)
    p = g.positions
    n = g.normals
    v0 = p[tri[:, 0]]
    v1 = p[tri[:, 1]]
    v2 = p[tri[:, 2]]

    anim = scene.animation()
    o2w = anim.transforms_3x4()
    w2o = anim.inverse_transforms_3x4()

    if scene.skybox is not None:
        skybox = np.asarray(scene.skybox, np.float32)
    else:
        skybox = np.zeros((6, 1, 1, 3), np.float32)

    n0, n1, n2 = n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]]
    tri_n_soa = np.ascontiguousarray(
        np.concatenate([n0.T, n1.T, n2.T], axis=0).astype(np.float32)
    )  # (9, T)
    sky8 = np.clip(skybox * 255.0 + 0.5, 0, 255).astype(np.uint32)
    skybox_u32 = (
        sky8[..., 0] | (sky8[..., 1] << 8) | (sky8[..., 2] << 16)
    ).reshape(-1)  # (6*H*W,)

    if scene.config.skybox_filter == "bilinear2x":
        skybox_u32_2x = jnp.asarray(_prefilter_2x(skybox))
    else:
        skybox_u32_2x = None

    dev = DeviceScene(
        tri_v0=jnp.asarray(v0),
        tri_e1=jnp.asarray(v1 - v0),
        tri_e2=jnp.asarray(v2 - v0),
        tri_n0=jnp.asarray(n0),
        tri_n1=jnp.asarray(n1),
        tri_n2=jnp.asarray(n2),
        o2w=jnp.asarray(o2w),
        w2o=jnp.asarray(w2o),
        materials=jnp.asarray(scene.material_types),
        light_pos=jnp.asarray(scene.config.light_position, jnp.float32),
        light_intensity=jnp.asarray(scene.config.light_intensity, jnp.float32),
        tri_n_soa=jnp.asarray(tri_n_soa),
        skybox_u32=jnp.asarray(skybox_u32),
        skybox_u32_2x=skybox_u32_2x,
    )

    prim_ranges = []
    for mesh_id in range(g.num_meshes):
        _, ps = g.mesh_slice(mesh_id)
        prim_ranges.append((ps.start, ps.stop - ps.start))

    static = SceneStatic(
        mesh_prim_ranges=tuple(prim_ranges),
        instance_mesh=tuple(inst.mesh_id for inst in scene.instances),
        sky_hw=(int(skybox.shape[1]), int(skybox.shape[2])),
    )
    return dev, static


def _prefilter_2x(skybox: np.ndarray) -> np.ndarray:
    """Packed RGB8 map at twice the face size, bilinearly upsampled."""
    # 2x bilinear prefilter: sample positions land on the half-texel grid,
    # so a nearest tap here == bilinear with weights quantized to {0,.5,1}.
    # Separable and per-face in float32 to keep host memory bounded
    # (the naive fancy-indexed form materialized multi-GB temporaries).
    fh, fw = skybox.shape[1], skybox.shape[2]

    def upsample_axis(img, axis, size):
        pos = np.clip((np.arange(2 * size, dtype=np.float32) - 0.5) / 2.0,
                      0, size - 1)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, size - 1)
        w = (pos - i0).astype(np.float32)
        a = np.take(img, i0, axis=axis)
        b = np.take(img, i1, axis=axis)
        shape = [1] * img.ndim
        shape[axis] = 2 * size
        w = w.reshape(shape)
        return a * (1 - w) + b * w

    skybox_u32_2x = np.empty((6, 2 * fh * 2 * fw), np.uint32)
    for f in range(6):
        face = skybox[f].astype(np.float32)          # (H, W, 3)
        face2 = upsample_axis(upsample_axis(face, 0, fh), 1, fw)
        f8 = np.clip(face2 * 255.0 + 0.5, 0, 255).astype(np.uint32)
        skybox_u32_2x[f] = (
            f8[..., 0] | (f8[..., 1] << 8) | (f8[..., 2] << 16)
        ).reshape(-1)
    return skybox_u32_2x.reshape(-1)
