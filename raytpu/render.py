"""High-level render API: host Scene → images.

Wraps the jitted integrator with host-side scene upload, animation stepping
and framebuffer conversion — the frame-loop layer (L5) of the reference
(``src/main.cpp:2787-2972``) minus windowing, reusable by every frontend
(headless, flythrough, interactive) and by the benchmark harness.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from raytpu.camera import Camera
from raytpu.device_scene import build_device_scene
from raytpu.integrator import RenderStatic, render_frame
from raytpu.scene import AnimationState, Scene


class Renderer:
    """Stateful convenience wrapper: owns the device scene, the animation
    state and the camera; ``step(dt)`` advances animation and renders one
    frame — one iteration of the reference's main loop
    (``src/main.cpp:2795-2972``)."""

    def __init__(self, scene: Scene, camera: Optional[Camera] = None):
        self.scene = scene
        self.camera = camera or Camera(scene.config.camera_position)
        self.device_scene, self.static = build_device_scene(scene)
        if scene.config.bvh_builder != "brute" and scene.config.traversal != "brute":
            from raytpu.accel import attach_bvh

            self.device_scene, self.static = attach_bvh(
                self.device_scene, self.static, scene
            )
        self.render_static = RenderStatic.from_config(scene.config)
        self.animation = AnimationState(scene.instances)
        self.time_param = 0.0
        self._mesh = None
        if scene.config.validation:
            from raytpu.utils.validation import check_scene

            check_scene(self.device_scene, self.static)

    def set_transforms(self, time_param: float) -> None:
        """Advance instance animation to ``time_param`` (the refit analog,
        ``src/main.cpp:2836-2861``)."""
        self.time_param = time_param
        self.animation.step(time_param)
        self.device_scene = self.device_scene.with_transforms(
            self.animation.transforms_3x4(),
            self.animation.inverse_transforms_3x4(),
        )

    def render(self) -> jnp.ndarray:
        """Render one frame → (H, W, 3) float32 device array.

        With ``config.devices > 1`` the frame is sharded row-wise over a
        device mesh (``raytpu/parallel/dist.py``)."""
        if self.scene.config.devices > 1:
            from raytpu.parallel import make_mesh, render_sharded

            if self._mesh is None:
                self._mesh = make_mesh(self.scene.config.devices)
            img = render_sharded(
                self.device_scene,
                self.static,
                self.render_static,
                self.camera.basis(),
                self._mesh,
            )
        else:
            img = render_frame(
                self.device_scene,
                self.static,
                self.render_static,
                jnp.asarray(self.camera.basis()),
            )
        if self.scene.config.validation:
            from raytpu.utils.validation import check_frame

            check_frame(img)
        return img

    def render_u8(self):
        """Render and quantize to uint8 ON DEVICE — 4x less host-transfer
        for presentation paths (the swapchain-copy analog,
        src/main.cpp:2597-2735)."""
        img = self.render()
        return jnp.clip(img * 255.0 + 0.5, 0, 255).astype(jnp.uint8)

    def render_np(self) -> np.ndarray:
        return np.asarray(self.render())

    def step(self, time_param: float) -> np.ndarray:
        self.set_transforms(time_param)
        return self.render_np()
