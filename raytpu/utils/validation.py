"""Render-path validation guards.

The analog of the reference's Vulkan validation layers + synchronization
validation (``src/main.cpp:813-848``, gated by ``VALIDATION_LAYERS_ENABLED``
in ``include/config.h:24``): compile-time-optional checks with fail-fast,
colored reporting (``throwExceptionVulkanAPI`` analog:
``raytpu.utils.log.fail``).

Enabled via ``RenderConfig.validation=True``: scene arrays are checked at
upload, and every rendered frame is checked for NaN/Inf and wildly
out-of-range radiance before it leaves the renderer.
"""

from __future__ import annotations

import numpy as np

from raytpu.utils import log


def check_scene(device_scene, static) -> None:
    """Structural checks on the uploaded scene (fail fast at load time)."""
    def _finite(name, arr):
        if arr is None:
            return
        a = np.asarray(arr)
        if not np.isfinite(a).all():
            log.fail(f"scene array {name} contains non-finite values")

    for name in ("tri_v0", "tri_e1", "tri_e2", "o2w", "w2o", "light_pos"):
        _finite(name, getattr(device_scene, name))
    mats = np.asarray(device_scene.materials)
    if mats.size and (mats.min() < 0 or mats.max() > 2):
        log.fail(f"material types out of range 0..2: {mats}")
    if static.has_bvh:
        miss = np.asarray(device_scene.bvh_miss)
        for base, count in static.mesh_node_ranges:
            m = miss[base : base + count]
            if not ((m > np.arange(count)) & (m <= count)).all():
                log.fail("BVH skip links are not monotone — corrupt build")
    log.verbose("scene validation passed")


def check_frame(image, context: str = "frame") -> None:
    """Post-render guard: NaN/Inf and radiance-range checks."""
    img = np.asarray(image)
    bad = ~np.isfinite(img)
    if bad.any():
        ys, xs = np.nonzero(bad.any(axis=-1))
        log.fail(
            f"{context}: {bad.sum()} non-finite values "
            f"(first at pixel x={xs[0]}, y={ys[0]})"
        )
    if img.max() > 1e3:
        log.warning(
            f"{context}: radiance exceeds 1e3 (max {img.max():.3g}) — "
            "suspicious for this integrator"
        )


def jit_guard(arrays, context: str):
    """In-jit NaN/Inf guard (the checkify-style analog of synchronization
    validation, SURVEY.md §5): counts non-finite lanes across ``arrays``
    (a tuple of same-shape float arrays) and reports through an UNORDERED
    best-effort ``jax.debug.callback`` when any appear — runs INSIDE the
    compiled frame, so it fires even for intermediate state that never
    reaches the host (diagnostics only; the report may arrive after the
    frame returns). Returns ``arrays`` unchanged.
    """
    import jax
    import jax.numpy as jnp

    bad = sum(
        jnp.sum(~jnp.isfinite(a), dtype=jnp.int32) for a in arrays
    )

    def report(bad_count):
        if int(bad_count) > 0:
            log.error(
                f"validation: {int(bad_count)} non-finite values in "
                f"{context} (inside jit)"
            )

    jax.debug.callback(report, bad, ordered=False)
    return arrays
