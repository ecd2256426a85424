"""Golden-image fidelity at realistic scale.

Compares raytpu full renders at 128² against in-repo goldens produced by
the vectorized float64 oracle (``tests/gen_goldens.py``) over the real
in-repo stand-in assets — teapot mirror (catches normal-transform
regressions on curved geometry, ``src/shader.rchit:93-94``) and cube_scene
refraction (catches Snell/TIR regressions, ``src/shader.rgen:139-177``).
Regenerate with ``python -m tests.gen_goldens`` only when semantics
intentionally change.
"""

import os

import numpy as np
import pytest

from raytpu.utils import ssim

from tests.gen_goldens import GOLDEN_DIR, SIZE, build_case, golden_cases

CASES = {name: (objs, bounces, spp)
         for name, objs, bounces, spp in golden_cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}_{SIZE}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {path} not generated")
    golden = np.load(path)["image"]
    objs, bounces, spp = CASES[name]
    renderer, _, _ = build_case(objs, bounces, spp)
    img = renderer.render_np()
    assert img.shape == golden.shape
    s = ssim(img, golden, win=8)
    assert s > 0.98, f"SSIM {s:.4f} vs golden {name}"
