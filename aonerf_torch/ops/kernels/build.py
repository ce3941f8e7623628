"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, ``build/lib<name>-<hash>.so`` beside this file. The hash covers
the source, every header in ``csrc/`` (``*.cuh``, ``*.h``), ``DEFINES`` and
the library's own definitions, so an edited source or shared header
rebuilds. A library is built for one pair of encoded widths
(:func:`width_defines`: none for the default 63 / 27), so a first run at
another pair builds its libraries. Nothing is compiled when the module is
imported: the first caller builds. Without ``nvcc``, or when a build fails,
this raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Preprocessor definitions (NAME=VALUE) that every source is built with,
# part of each library's hash: none, but where a tool sets them before the
# first build to measure a variant (tools/torch_bf16_accuracy.py
# --fwd-bf16-run).
DEFINES: Tuple[str, ...] = ()
# The encoded widths the kernels take when a build names none (xenc's and
# venc's features at the 10 / 4 degrees).
DEFAULT_WIDTHS = (63, 27)

# A library to build: a source's name, or (name, its own definitions).
Target = Union[str, Tuple[str, Tuple[str, ...]]]

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# What ptxas said about each built library (registers, shared memory,
# spills), by its label (:func:`label`).
ptxas_log: Dict[str, str] = {}


def width_defines(pos_dim: int, view_dim: int) -> Tuple[str, ...]:
    """The definitions of a library for encoded widths pos_dim (xenc's
    features) and view_dim (venc's): none at the default pair."""
    if (pos_dim, view_dim) == DEFAULT_WIDTHS:
        return ()
    return (f"AONERF_POS_DIM={pos_dim}", f"AONERF_VIEW_DIM={view_dim}")


def _split(target: Target) -> Tuple[str, Tuple[str, ...]]:
    return (target, ()) if isinstance(target, str) else (target[0], tuple(target[1]))


def label(target: Target) -> str:
    """A library's name in logs: the source's, then its definitions."""
    name, defines = _split(target)
    return " ".join((name, *defines))


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(target: Target) -> Path:
    name, defines = _split(target)
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(repr(DEFINES).encode())
    if defines:
        h.update(repr(defines).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(target: Target, out: Path) -> subprocess.Popen:
    name, defines = _split(target)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in (*DEFINES, *defines)), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(targets: Iterable[Target]) -> Dict[Target, Path]:
    """Compile the named libraries (a source's name, or (name, definitions)
    such as :func:`width_defines` gives) that are not built yet, all nvcc
    processes at once, and return each one's path by the target as given.
    Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {t: _lib_path(t) for t in targets}
    procs = {t: _start(t, p) for t, p in paths.items() if not p.exists()}
    failed = []
    for t, proc in procs.items():
        log, _ = proc.communicate()
        ptxas_log[label(t)] = log
        tmp = paths[t].with_suffix(f".tmp{os.getpid()}")
        if proc.returncode != 0:
            failed.append(f"{label(t)} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[t])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def all_sources() -> list:
    """Names of every CUDA source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu with these definitions, built at
    first use; libraries of several definitions load side by side."""
    key = (name, tuple(defines))
    with _lock:
        if key not in _loaded:
            target = key if defines else name
            path = build([target])[target]
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]
