"""The native (C++) scene loader, built with g++ and loaded with ctypes
(counterpart of ``aonerf.native``).

``get_loader()`` compiles ``loader.cpp`` at first use into
``build/libaonerf_loader-<hash>.so`` beside this file (the name hashes the
source and the compiler command) and loads it. A failed build raises with
the compiler's message. ``AONERF_NO_NATIVE=1``, read at every call, is the
one way to choose the PIL path: ``get_loader()`` then returns None and the
functions below return None / False.

The decoder reads 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA PNGs.
A file of another size (or another PNG flavour) makes a function return
None / False, and the dataset reads that file through PIL, which resizes it
(and raises on a file it cannot read either).

``scene_loads`` and ``png_decodes`` count the calls that the library
served, so a caller can tell which path a dataset took.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
scene_loads = 0
png_decodes = 0


def _lib_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(repr((CXX, CXX_FLAGS)).encode())
    return BUILD_DIR / f"libaonerf_loader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the loader unless it is built; return the library's path.
    Each process writes a name of its own and renames it into place, so
    processes that build at once each load a whole library. Raises with the
    compiler's output when the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-lz", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_loader() -> Optional[ctypes.CDLL]:
    """The loaded library (built at first use), or None when
    ``AONERF_NO_NATIVE`` is set."""
    global _lib
    if os.environ.get("AONERF_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.aonerf_load_scene.restype = ctypes.c_int
            lib.aonerf_load_scene.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.aonerf_decode_png.restype = ctypes.c_int
            lib.aonerf_decode_png.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ]
            lib.aonerf_decode_png_u8.restype = ctypes.c_int
            lib.aonerf_decode_png_u8.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _out_buffer(a: np.ndarray, shape: tuple, name: str) -> None:
    if a.dtype != np.float32 or not a.flags.c_contiguous or a.size != int(np.prod(shape)):
        raise ValueError(f"{name}: expected a C-contiguous float32 array of {int(np.prod(shape))} values, "
                         f"got {a.dtype} {a.shape}")


def load_scene_native(
    paths,
    c2ws: np.ndarray,
    directions: np.ndarray,
    h: int,
    w: int,
    white_bkgd: bool,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    rgbs: np.ndarray,
    alphas: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> bool:
    """Fill the preallocated flat (n*h*w, 3) float32 buffers (rays_o, unit
    rays_d, rgb blended on white or black, and the (n*h*w,) alphas when
    given) from the PNGs and their (n, 3, 4) c2ws, on a thread pool. False
    when AONERF_NO_NATIVE is set or an image is of another size or flavour
    (the caller then reads the scene through PIL)."""
    global scene_loads
    lib = get_loader()
    if lib is None:
        return False
    n, npix = len(paths), h * w
    for a, name in ((rays_o, "rays_o"), (rays_d, "rays_d"), (rgbs, "rgbs")):
        _out_buffer(a, (n * npix, 3), name)
    if alphas is not None:
        _out_buffer(alphas, (n * npix,), "alphas")
    c2ws = np.ascontiguousarray(c2ws, np.float32).reshape(n, 12)
    directions = np.ascontiguousarray(directions, np.float32).reshape(npix, 3)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.aonerf_load_scene(
        arr, n, _fptr(c2ws), _fptr(directions), h, w, int(white_bkgd),
        _fptr(rays_o), _fptr(rays_d), _fptr(rgbs), _fptr(alphas) if alphas is not None else None, n_threads,
    )
    if rc == 0:
        scene_loads += 1
    return rc == 0


def decode_png_u8_native(path: str, w: int, h: int) -> Optional[np.ndarray]:
    """One PNG as an (h, w, 4) uint8 RGBA array (alpha 255 when the file
    has none); None when AONERF_NO_NATIVE is set or the file is of another
    size or flavour (the caller then reads it through PIL)."""
    global png_decodes
    lib = get_loader()
    if lib is None:
        return None
    out = np.empty((h, w, 4), np.uint8)
    rc = lib.aonerf_decode_png_u8(os.fsencode(path), w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    png_decodes += 1
    return out


def decode_png_native(
    path: str, w: int, h: int, white_bkgd: bool, rgb: np.ndarray, alpha: Optional[np.ndarray] = None
) -> bool:
    """Decode one PNG into the (h*w, 3) float32 rgb, blended on white or
    black (and the (h*w,) alpha when given). False as for
    :func:`decode_png_u8_native`."""
    global png_decodes
    lib = get_loader()
    if lib is None:
        return False
    _out_buffer(rgb, (h * w, 3), "rgb")
    if alpha is not None:
        _out_buffer(alpha, (h * w,), "alpha")
    rc = lib.aonerf_decode_png(os.fsencode(path), w, h, int(white_bkgd), _fptr(rgb),
                               _fptr(alpha) if alpha is not None else None)
    if rc == 0:
        png_decodes += 1
    return rc == 0
