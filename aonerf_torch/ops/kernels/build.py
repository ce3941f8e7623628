"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface, ``build/lib<name>-<hash>.so`` beside this file. The hash covers
the source, every header in ``csrc/`` (``*.cuh``, ``*.h``) and ``DEFINES``,
so an edited source or shared header rebuilds. Nothing is compiled when the
module is imported: the first caller builds. Without ``nvcc``, or when a
build fails, this raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

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

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# What ptxas said about each built source (registers, shared memory, spills).
ptxas_log: Dict[str, str] = {}


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


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(repr(DEFINES).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in DEFINES), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all nvcc processes
    at once, and return each library's path. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {n: _start(n, p) for n, p in paths.items() if not p.exists()}
    failed = []
    for n, proc in procs.items():
        log, _ = proc.communicate()
        ptxas_log[n] = log
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def all_sources() -> list:
    """Names of every CUDA source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _loaded:
            path = build([name])[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
