"""Headless (offline) rendering frontend.

The replacement for the reference's swapchain presentation
(``src/main.cpp:2905-2965``): frames go to image files instead of a window.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from raytpu.io.image import write_image
from raytpu.presets import load_preset_scene
from raytpu.render import Renderer
from raytpu.utils import log


def render_still(
    preset_or_config,
    out_path: str,
    time_param: float = 0.0,
    camera=None,
    highpoly_depth: int = 7,
) -> np.ndarray:
    """Render one frame of a preset/config and write it to ``out_path``."""
    scene = load_preset_scene(preset_or_config, highpoly_depth=highpoly_depth)
    renderer = Renderer(scene, camera=camera)
    img = renderer.step(time_param)
    write_image(out_path, img)
    log.info(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]})")
    return img


def render_sequence(
    preset_or_config,
    out_dir: str,
    num_frames: int,
    dt: float = 1.0 / 60.0,
    camera=None,
    highpoly_depth: int = 7,
) -> None:
    """Render an animation sequence at fixed virtual time steps.

    Time parameterization matches the reference main loop:
    ``timeParam = elapsed_seconds * 0.1`` (``src/main.cpp:2799``).
    """
    os.makedirs(out_dir, exist_ok=True)
    scene = load_preset_scene(preset_or_config, highpoly_depth=highpoly_depth)
    renderer = Renderer(scene, camera=camera)
    from raytpu.utils import FpsCounter

    fps_counter = FpsCounter(print_fn=log.info)
    for i in range(num_frames):
        time_param = (i * dt) * 0.1
        img = renderer.step(time_param)
        write_image(os.path.join(out_dir, f"frame_{i:05d}.png"), img)
        if scene.config.test_fps:  # TEST_FPS analog (config.h:21-22)
            fps_counter.frame()
    log.info(f"wrote {num_frames} frames to {out_dir}")
