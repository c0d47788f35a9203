"""Build and load the port's CUDA kernels (``tpu_cc_manager_torch/csrc``).

The counterpart of ``tpu_cc_manager/utils/compilation_cache.py``: where the
JAX package keeps XLA's compiled programs on disk, the port keeps its kernel
libraries there. Each ``csrc/<name>.cu`` compiles on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, and is loaded with ``ctypes``. Pointers and the stream cross as
``c_void_p``; each C entry returns ``cudaGetLastError()`` and :func:`check`
raises when it is not 0. Building uses the repository's sources only.
Nothing happens at import: the first :func:`load` (or an explicit
:func:`build`) compiles, so CPU-only hosts never need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept beside the library.
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points of each library: name -> {symbol: argtypes}.
SIGNATURES: dict[str, dict[str, list]] = {
    "matmul": {
        "tcc_matmul_sm90": [_P, _P, _P, _I, _I, _I, _I, _P],
        "tcc_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        "tcc_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        "tcc_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        "tcc_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        "tcc_flash_fwd_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
        "tcc_flash_bwd_dq_sm90": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
        "tcc_flash_bwd_dkv_sm90": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    },
}

# Loaded libraries, one per source for the life of the process (a shared
# library cannot be unloaded safely while kernels may still run).
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A C entry returned a non-zero cudaError_t."""


def _nvcc() -> str:
    # PyTorch's lookup: CUDA_HOME / CUDA_PATH, then nvcc on PATH, then the
    # toolkit's default install location.
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every shared
    header under ``csrc/`` (a header edit rebuilds) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing library in ``names`` (default: all), one nvcc
    per source, all started together. Returns seconds per library built
    (an up-to-date library is not rebuilt and is absent from the result).
    Each build writes to a private temporary name and is renamed into
    place, so concurrent processes never load a half-written file."""
    names = list(SIGNATURES) if names is None else names
    missing = [name for name in names if not library_path(name).exists()]
    if not missing:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        pending[name] = (proc, tmp, out, time.perf_counter())
    built = {}
    failures = []
    for name, (proc, tmp, out, t0) in pending.items():
        stdout, stderr = proc.communicate()
        built[name] = time.perf_counter() - t0
        log = out.with_suffix(".log")
        log.write_text(stdout + stderr, encoding="utf-8")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc rc={proc.returncode}\n{stderr[-4000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return built


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(encoding="utf-8") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def loaded() -> list[str]:
    """Names of the libraries this process has loaded."""
    return sorted(_LIBS)


def check(rc: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero cudaError_t."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc}")
