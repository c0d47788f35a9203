"""Build and load the port's CUDA kernels (``tpu_cc_manager_torch/csrc``).

The counterpart of ``tpu_cc_manager/utils/compilation_cache.py``: where the
JAX package keeps XLA's compiled programs on disk, the port keeps its kernel
libraries there. Each ``csrc/<name>.cu`` compiles on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/<name>-<hash>.so

keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, and is loaded with ``ctypes``. Pointers and the stream cross as
``c_void_p``; each C entry returns ``cudaGetLastError()`` and :func:`check`
raises when it is not 0. Building uses the repository's sources only.
Nothing happens at import: the first :func:`load` (or an explicit
:func:`build`) compiles, so CPU-only hosts never need ``nvcc``.

A library is looked up in every one of :func:`candidate_build_dirs`, in
order, before anything is built: ``$TPU_CC_CACHE_DIR/torch_kernels`` (the
DaemonSet sets it), then ``build/torch_kernels`` beside the package, where
an image puts the libraries it prebuilt (``python -m
tpu_cc_manager_torch.ops._build``), then the tmpdir. A directory and the
library in it are loaded only when they belong to this user or to root and
neither group nor other may write them, so a read-only, root-owned
directory of an image serves, and a library another user could have
planted does not.

Only a missing library is built, into the first candidate this process can
create and write, chosen as the JAX package chooses its compilation cache.
A build directory is created private (mode 0700), and one that exists is
taken only when this user owns it and no one else may write it.

    python -m tpu_cc_manager_torch.ops._build [--dir DIR]

builds every ``csrc/*.cu`` into ``DIR`` (default: :func:`build_dir`) and
prints the seconds per library; an image runs it to ship its libraries.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import pathlib
import stat
import subprocess
import sys
import tempfile
import threading
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
        "tcc_matmul_sm90": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
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

# Wrappers may launch from several threads at once (chip_smoke.py runs tp
# ranks as threads of one card): the counts are read-modify-writes.
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, variant: str) -> None:
    """One launch of ``wrapper``'s kernel ``variant``: add one to its
    ``launches`` and ``launches_by_variant[variant]``."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_variant[variant] += 1


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


def candidate_build_dirs() -> list[pathlib.Path]:
    """Preference order: a subdirectory of ``$TPU_CC_CACHE_DIR`` (preferred,
    not exclusive: an override the kubelet created root-owned falls
    through), ``BUILD_DIR``, then ``<tmpdir>/tpu-cc-torch-kernels``."""
    candidates = [BUILD_DIR, pathlib.Path(tempfile.gettempdir()) / "tpu-cc-torch-kernels"]
    override = os.environ.get("TPU_CC_CACHE_DIR")
    if override:
        candidates.insert(0, pathlib.Path(override) / "torch_kernels")
    return candidates


def _unsafe(candidate: pathlib.Path, owners: tuple[int, ...] = ()) -> str | None:
    """Why another user could put a library in ``candidate`` (a directory
    or a library), or None. It must belong to this user or to one of
    ``owners``."""
    st = candidate.stat()
    if st.st_uid != os.geteuid() and st.st_uid not in owners:
        return f"owned by uid {st.st_uid}, not {os.geteuid()}"
    if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        return f"group- or other-writable (mode {stat.S_IMODE(st.st_mode):o})"
    return None


@functools.cache
def _first_writable(candidates: tuple[pathlib.Path, ...]) -> pathlib.Path:
    errors = []
    for candidate in candidates:
        try:
            candidate.mkdir(mode=0o700, parents=True, exist_ok=True)
            unsafe = _unsafe(candidate)
            if unsafe:
                errors.append(f"{candidate}: {unsafe}")
                continue
            tempfile.TemporaryFile(dir=candidate).close()
            return candidate
        except OSError as e:
            errors.append(f"{candidate}: {e.strerror or e}")
    raise KernelBuildError("no writable kernel build directory: " + "; ".join(errors))


def build_dir() -> pathlib.Path:
    """The first of :func:`candidate_build_dirs` that can be created and
    written and that no other user may write, resolved once per process
    (per candidate list). Raises
    :class:`KernelBuildError` naming every candidate when none can: the
    port has no mode without built libraries."""
    return _first_writable(tuple(candidate_build_dirs()))


def library_name(name: str) -> str:
    """The file ``csrc/<name>.cu`` builds to: keyed by the source, every
    shared header under ``csrc/`` (a header edit rebuilds) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> pathlib.Path:
    """Where a build of ``csrc/<name>.cu`` writes its library."""
    return build_dir() / library_name(name)


def find_library(name: str) -> pathlib.Path | None:
    """The first library of ``csrc/<name>.cu`` in :func:`candidate_build_dirs`
    that this process may load (directory and file owned by this user or
    root, neither group- nor other-writable), or None."""
    for candidate in candidate_build_dirs():
        path = candidate / library_name(name)
        try:
            if path.is_file() and not (_unsafe(candidate, owners=(0,))
                                       or _unsafe(path, owners=(0,))):
                return path
        except OSError:
            continue
    return None


def sources() -> list[str]:
    """The name of every ``csrc/*.cu``."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def _up_to_date(path: pathlib.Path) -> bool:
    """Whether ``path`` is a built library that only this user could have
    written."""
    try:
        return path.is_file() and _unsafe(path) is None
    except OSError:
        return False


def build(names: list[str] | None = None, directory: pathlib.Path | None = None
          ) -> dict[str, float]:
    """Compile every library in ``names`` (default: all) missing from
    ``directory`` (default: :func:`build_dir`; one this user owns), one nvcc
    per source, all started together. Returns seconds per library built
    (an up-to-date library is not rebuilt and is absent from the result; a
    library another user could have written is rebuilt over). Each build
    writes to a private temporary name, made writable by this user only,
    and is renamed into place, so concurrent processes never load a
    half-written file."""
    names = list(SIGNATURES) if names is None else names
    if directory is None:
        directory = build_dir()
    else:
        directory.mkdir(mode=0o700, parents=True, exist_ok=True)
        unsafe = _unsafe(directory)
        if unsafe:
            raise KernelBuildError(f"will not build into {directory}: {unsafe}")
    missing = [name for name in names if not _up_to_date(directory / library_name(name))]
    if not missing:
        return {}
    nvcc = _nvcc()
    pending = {}
    for name in missing:
        out = directory / library_name(name)
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
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return built


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for ``name``,
    kept beside the library this process would load."""
    log = (find_library(name) or library_path(name)).with_suffix(".log")
    return log.read_text(encoding="utf-8") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``: the first one
    :func:`find_library` finds, else a new build. A library another user
    could have written is never loaded."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = find_library(name)
    if path is None:
        build([name])
        path = find_library(name)
        if path is None:
            raise KernelBuildError(f"the build of {name} left no library this user may load "
                                   f"({library_path(name)})")
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_cc_manager_torch.ops._build",
        description="Build every csrc/*.cu kernel library for sm_90a with nvcc.")
    parser.add_argument("--dir", type=pathlib.Path, default=None,
                        help="build into DIR (default: the first writable build directory)")
    args = parser.parse_args(argv)
    directory = args.dir or build_dir()
    try:
        built = build(sources(), directory)
    except KernelBuildError as e:
        print(f"KernelBuildError: {e}", file=sys.stderr)
        return 1
    for name in sources():
        took = f"{built[name]:.3f} s" if name in built else "up to date"
        print(f"{name}: {took} -> {directory / library_name(name)}")
    print(json.dumps({"dir": str(directory), "seconds": built}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
