"""Build-on-first-use loader for the native library (``native/``).

``native/libraytpu_native.so`` (OBJ parser, SAH BVH builder, baseline JPEG
decoder) is built from the C++ sources in ``native/`` with
``make -C native``; it is never committed. :func:`load` runs that build
once when the library is missing (serialized across processes by a lock
file, so parallel test workers do not race) and returns the loaded
library, or None when no compiler is available — callers then use the
pure-Python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
LIB_PATH = os.path.join(NATIVE_DIR, "libraytpu_native.so")

_lib: Optional[ctypes.CDLL] = None
_failed = False


def build() -> None:
    """Run ``make -C native`` (raises on failure)."""
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(LIB_PATH):
            subprocess.run(["make", "-s", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=600)


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None if it cannot be."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        if not os.path.exists(LIB_PATH):
            build()
        _lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        _failed = True
    return _lib
