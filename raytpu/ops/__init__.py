from raytpu.ops.intersect import (
    BIG_T,
    Hit,
    brute_anyhit,
    brute_closest,
    moller_trumbore,
    ray_aabb,
    safe_inverse,
)
from raytpu.ops.sky import cube_face_st, sample_cubemap

__all__ = [
    "BIG_T",
    "Hit",
    "brute_anyhit",
    "brute_closest",
    "cube_face_st",
    "moller_trumbore",
    "ray_aabb",
    "safe_inverse",
    "sample_cubemap",
]
