"""Build and load the CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -Xptxas -v

into ``drep_tpu_torch/_build/lib<name>_<hash>.so`` (the hash is of the
source and the shared ``csrc/*.cuh`` headers, so an edited kernel
rebuilds). Building happens at first use, never at import;
:func:`build_all` starts one nvcc per source at once and keeps each
build's compiler output (ptxas's registers, shared memory and spills per
kernel) in :data:`BUILD_LOG`.
Every launch function returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("mash_shared", "indicator_mm", "intersect", "ring_step", "ring_step_mm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output of each source built by this process
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    # the source and every shared header it may include
    for src in [f"{name}.cu", *sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str] | None:
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job: tuple[subprocess.Popen, str, str]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc={proc.returncode}):\n{out[-4000:]}")
    BUILD_LOG[name] = out
    os.replace(tmp, so)


def build_all() -> None:
    """Compile every kernel source that has no up-to-date library, all
    nvcc processes running at once."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        errors = []
        for name, job in jobs.items():
            if job is not None:
                try:
                    _finish(name, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not os.path.exists(_so_path(name)):
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_so_path(name))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
