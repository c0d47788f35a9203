"""Where the port's kernel libraries build: the first writable candidate.

``ops/_build.py`` chooses its directory as the JAX package chooses its
compilation cache (``tpu_cc_manager/utils/compilation_cache.py``):
``$TPU_CC_CACHE_DIR``, then ``build/torch_kernels`` beside the package, then
the tmpdir, and takes only a directory that no other user may write. The
package is copied into a read-only directory, as an image's root-owned
site-packages is, and a child process builds with ``nvcc`` stubbed by a
script that writes its ``-o`` file.

The read-only modes must bind the child. Another uid (65534) could not
reach ``tmp_path``, which pytest keeps under a base directory of mode 0700,
without widening the modes of directories above it, which no test does.
So as root the child stays root and first drops the capabilities that
override file modes (CAP_DAC_OVERRIDE, CAP_DAC_READ_SEARCH). As another
user, the modes bind already."""

import json
import os
import pathlib
import shutil
import stat
import subprocess
import sys

import pytest

from tpu_cc_manager_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AS_ROOT = os.geteuid() == 0

# The child's tmpdir is $TMPDIR even when it is read-only (tempfile would
# otherwise fall back to /tmp, which every user may write). With --no-dac
# it first gives up, for itself and what it starts, the capabilities that
# let root write past a file's mode, and proves it on the read-only copy.
CHILD = """
import ctypes, os, sys, tempfile
if sys.argv[3] == "--no-dac":
    libc = ctypes.CDLL(None, use_errno=True)
    class Header(ctypes.Structure):
        _fields_ = [("version", ctypes.c_uint32), ("pid", ctypes.c_int)]
    class Data(ctypes.Structure):
        _fields_ = [("effective", ctypes.c_uint32), ("permitted", ctypes.c_uint32),
                    ("inheritable", ctypes.c_uint32)]
    header, data = Header(0x20080522, 0), (Data * 2)()  # _LINUX_CAPABILITY_VERSION_3
    dac = (1 << 1) | (1 << 2)  # CAP_DAC_OVERRIDE, CAP_DAC_READ_SEARCH
    for cap in (1, 2):  # PR_CAPBSET_DROP: an exec'd child must not regain them
        if libc.prctl(24, cap, 0, 0, 0) != 0:
            sys.exit(f"prctl(PR_CAPBSET_DROP, {cap}): errno {ctypes.get_errno()}")
    if libc.capget(ctypes.byref(header), data) != 0:
        sys.exit(f"capget: errno {ctypes.get_errno()}")
    data[0].effective &= ~dac; data[0].permitted &= ~dac; data[0].inheritable &= ~dac
    if libc.capset(ctypes.byref(header), data) != 0:
        sys.exit(f"capset: errno {ctypes.get_errno()}")
    try:
        open(os.path.join(sys.argv[1], "probe"), "w").close()
        sys.exit("the read-only copy is still writable")
    except PermissionError:
        pass
tempfile.tempdir = os.environ["TMPDIR"]
sys.path.insert(0, sys.argv[1])
from tpu_cc_manager_torch.ops import _build
_build._nvcc = lambda: sys.argv[2]
try:
    built = _build.build(["matmul"])
except _build.KernelBuildError as e:
    print("KernelBuildError:", e)
    sys.exit(3)
path = _build.library_path("matmul")
assert sorted(built) == ["matmul"] and path.read_bytes() == b"stub library"
print(path)
"""

STUB_NVCC = """#!{python}
import sys
with open(sys.argv[sys.argv.index("-o") + 1], "wb") as f:
    f.write(b"stub library")
"""


def read_only(root) -> None:
    for dirpath, _, files in os.walk(root):
        for name in files:
            os.chmod(os.path.join(dirpath, name), 0o555)
        os.chmod(dirpath, 0o555)


def writable_dir(path) -> str:
    os.makedirs(path)
    os.chmod(path, 0o777)
    return str(path)


def read_only_dir(path) -> str:
    os.makedirs(path)
    os.chmod(path, 0o555)
    return str(path)


@pytest.fixture()
def site(tmp_path):
    """A read-only copy of the package and a stub compiler in it."""
    root = tmp_path / "site"
    shutil.copytree(os.path.join(REPO, "tpu_cc_manager_torch"), root / "tpu_cc_manager_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "nvcc").write_text(STUB_NVCC.format(python=sys.executable))
    read_only(root)
    return root


def build(site, tmp_path, **env_overrides):
    env = {k: v for k, v in os.environ.items() if k != "TPU_CC_CACHE_DIR"}
    env.update(PYTHONDONTWRITEBYTECODE="1", HOME=str(tmp_path), **env_overrides)
    mode = "--no-dac" if AS_ROOT else "--as-is"
    return subprocess.run([sys.executable, "-c", CHILD, str(site), str(site / "nvcc"), mode],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
                          env=env)


def test_the_override_is_preferred(site, tmp_path):
    cache = writable_dir(tmp_path / "cache")
    proc = build(site, tmp_path, TPU_CC_CACHE_DIR=cache,
                 TMPDIR=writable_dir(tmp_path / "tmp"))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    path = proc.stdout.strip()
    assert os.path.dirname(path) == os.path.join(cache, "torch_kernels")
    assert os.listdir(tmp_path / "tmp") == []


def test_an_unwritable_override_and_repo_fall_through_to_the_tmpdir(site, tmp_path):
    tmp = writable_dir(tmp_path / "tmp")
    proc = build(site, tmp_path, TPU_CC_CACHE_DIR=read_only_dir(tmp_path / "ro-cache"),
                 TMPDIR=tmp)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert os.path.dirname(proc.stdout.strip()) == os.path.join(tmp, "tpu-cc-torch-kernels")
    assert not (site / "build").exists()
    assert "PermissionError" not in proc.stderr


def test_nothing_writable_names_every_candidate(site, tmp_path):
    ro_cache = read_only_dir(tmp_path / "ro-cache")
    ro_tmp = read_only_dir(tmp_path / "ro-tmp")
    proc = build(site, tmp_path, TPU_CC_CACHE_DIR=ro_cache, TMPDIR=ro_tmp)
    assert proc.returncode == 3, proc.stdout + proc.stderr[-2000:]
    assert "Traceback" not in proc.stderr and "PermissionError" not in proc.stderr
    message = proc.stdout
    assert message.startswith("KernelBuildError: no writable kernel build directory")
    for candidate in (os.path.join(ro_cache, "torch_kernels"),
                      str(site / "build" / "torch_kernels"),
                      os.path.join(ro_tmp, "tpu-cc-torch-kernels")):
        assert candidate in message, candidate


def test_a_planted_tmpdir_is_refused(site, tmp_path):
    """A ``tpu-cc-torch-kernels`` that another user could write (here one
    left world-writable) is passed over, and nothing is built or loaded
    from it."""
    tmp = writable_dir(tmp_path / "tmp")
    planted = writable_dir(tmp_path / "tmp" / "tpu-cc-torch-kernels")
    proc = build(site, tmp_path, TPU_CC_CACHE_DIR=read_only_dir(tmp_path / "ro-cache"),
                 TMPDIR=tmp)
    assert proc.returncode == 3, proc.stdout + proc.stderr[-2000:]
    assert f"{planted}: group- or other-writable (mode 777)" in proc.stdout
    assert os.listdir(planted) == []


def test_a_directory_another_user_owns_is_refused(tmp_path, monkeypatch):
    """The ownership half of the same check, in process: a private
    directory of another uid is not taken."""
    theirs = tmp_path / "theirs"
    theirs.mkdir(mode=0o700)
    monkeypatch.setattr(_build.os, "geteuid", lambda: theirs.stat().st_uid + 1)
    with pytest.raises(_build.KernelBuildError, match="owned by uid"):
        _build._first_writable.__wrapped__((theirs,))


# ---------------------------------------------------------------------------
# Prebuilt libraries: what an image ships beside the package
# ---------------------------------------------------------------------------

# A child that loads K1's library from a read-only copy of the package with
# nvcc unavailable, and prints the path it loaded.
LOAD_CHILD = CHILD.split("tempfile.tempdir")[0] + """
tempfile.tempdir = os.environ["TMPDIR"]
sys.path.insert(0, sys.argv[1])
from tpu_cc_manager_torch.ops import _build
def no_nvcc():
    raise _build.KernelBuildError("nvcc was called")
_build._nvcc = no_nvcc
class Lib:  # ctypes.CDLL's part that load() uses: a settable entry per symbol
    def __init__(self, path):
        self.path = path
    def __getattr__(self, symbol):
        return type("Entry", (), {})()
_build.ctypes.CDLL = Lib
print(_build.load("matmul").path)
"""

# ``python -m tpu_cc_manager_torch.ops._build`` as runpy runs it, with
# torch's CUDA_HOME pointed at a stub toolkit (a CPU build of torch has none).
BUILD_COMMAND = """
import runpy, sys
import torch.utils.cpp_extension as cpp_extension
cpp_extension.CUDA_HOME = sys.argv[1]
sys.argv = ["python -m tpu_cc_manager_torch.ops._build", "--dir", sys.argv[2]]
runpy.run_module("tpu_cc_manager_torch.ops._build", run_name="__main__", alter_sys=True)
"""


class StubLib:
    """ctypes.CDLL's part that ``load`` uses: a settable entry per symbol."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, symbol):
        return type("Entry", (), {})()


def stub_toolkit(tmp_path) -> str:
    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True, exist_ok=True)
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    return str(toolkit)


def run_build_command(tmp_path, directory):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONDONTWRITEBYTECODE="1")
    return subprocess.run([sys.executable, "-c", BUILD_COMMAND, stub_toolkit(tmp_path),
                           str(directory)], capture_output=True, text=True, timeout=120,
                          cwd=str(tmp_path), env=env)


def test_the_build_command_writes_one_library_per_source(tmp_path):
    out = tmp_path / "prebuilt"
    proc = run_build_command(tmp_path, out)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    names = _build.sources()
    assert names == ["flash_attention", "matmul"]
    libraries = sorted(p.name for p in out.glob("*.so"))
    assert libraries == sorted(_build.library_name(n) for n in names)
    assert all((out / n).read_bytes() == b"stub library" for n in libraries)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["dir"] == str(out) and sorted(summary["seconds"]) == names
    # Run again: everything is up to date and nothing is rebuilt.
    again = run_build_command(tmp_path, out)
    assert json.loads(again.stdout.strip().splitlines()[-1])["seconds"] == {}


@pytest.mark.parametrize("owner", ["own-uid", "root"])
def test_a_read_only_prebuilt_directory_is_loaded_without_nvcc(tmp_path, monkeypatch, owner):
    """The directory an image ships (``build/torch_kernels`` beside the
    package), read-only, owned by this user or by root: its library is
    loaded and nothing is built, though a writable cache comes first."""
    prebuilt = tmp_path / "prebuilt"
    prebuilt.mkdir()
    (prebuilt / _build.library_name("matmul")).write_bytes(b"stub library")
    read_only(prebuilt)
    cache = tmp_path / "cache"
    cache.mkdir(mode=0o700)
    if owner == "root":  # the files are root's: this process runs as another uid
        if prebuilt.stat().st_uid != 0:
            pytest.skip("needs files owned by root")
        monkeypatch.setattr(_build.os, "geteuid", lambda: 1000)
    monkeypatch.setenv("TPU_CC_CACHE_DIR", str(cache))
    monkeypatch.setattr(_build, "BUILD_DIR", prebuilt)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc was called"))
    monkeypatch.setattr(_build.ctypes, "CDLL", StubLib)
    assert _build.load("matmul").path == str(prebuilt / _build.library_name("matmul"))
    assert not (cache / "torch_kernels").exists()


@pytest.mark.parametrize("what", ["directory", "library"])
def test_a_group_writable_prebuilt_library_is_refused(tmp_path, monkeypatch, what):
    prebuilt = tmp_path / "prebuilt"
    prebuilt.mkdir(mode=0o755)
    library = prebuilt / _build.library_name("matmul")
    library.write_bytes(b"stub library")
    library.chmod(0o644)
    (prebuilt if what == "directory" else library).chmod(0o775)
    monkeypatch.delenv("TPU_CC_CACHE_DIR", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", prebuilt)
    monkeypatch.setattr(_build.tempfile, "gettempdir", lambda: str(tmp_path / "tmp"))
    assert _build.find_library("matmul") is None
    library.chmod(0o644)
    prebuilt.chmod(0o755)
    assert _build.find_library("matmul") == library


@pytest.mark.parametrize("what", ["directory", "library"])
def test_load_never_loads_a_group_writable_library(tmp_path, monkeypatch, what):
    """``load`` refuses what ``find_library`` refuses: without nvcc it
    raises; with nvcc it builds a library of its own (over the planted one
    in its own build directory, or in the next candidate when the directory
    is the group-writable one) and loads that."""
    prebuilt = tmp_path / "prebuilt"
    prebuilt.mkdir(mode=0o755)
    planted = prebuilt / _build.library_name("matmul")
    planted.write_bytes(b"planted library")
    planted.chmod(0o644)
    (prebuilt if what == "directory" else planted).chmod(0o775)
    monkeypatch.delenv("TPU_CC_CACHE_DIR", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", prebuilt)
    monkeypatch.setattr(_build.tempfile, "gettempdir", lambda: str(tmp_path / "tmp"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", StubLib)

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("matmul")
    toolkit = stub_toolkit(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: os.path.join(toolkit, "bin", "nvcc"))
    loaded = pathlib.Path(_build.load("matmul").path)
    assert loaded.read_bytes() == b"stub library"
    assert _build._unsafe(loaded) is None and _build._unsafe(loaded.parent) is None
    if what == "directory":
        assert loaded.parent == tmp_path / "tmp" / "tpu-cc-torch-kernels"
        assert planted.read_bytes() == b"planted library"
    else:
        assert loaded == planted and stat.S_IMODE(loaded.stat().st_mode) == 0o755


def test_the_image_layout_loads_from_the_read_only_package(site, tmp_path):
    """As the image runs: the package and its prebuilt libraries read-only
    (root's, mode 0555 here), an empty writable ``$TPU_CC_CACHE_DIR``, no
    nvcc. The agent's child loads the prebuilt library and writes nothing."""
    os.chmod(site, 0o755)
    prebuilt = site / "build" / "torch_kernels"
    proc = run_build_command(tmp_path, prebuilt)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    read_only(site)
    cache = writable_dir(tmp_path / "cache")
    os.chmod(cache, 0o700)
    env = {k: v for k, v in os.environ.items() if k != "TPU_CC_CACHE_DIR"}
    env.update(PYTHONDONTWRITEBYTECODE="1", HOME=str(tmp_path), TPU_CC_CACHE_DIR=cache,
               TMPDIR=writable_dir(tmp_path / "tmp"))
    mode = "--no-dac" if AS_ROOT else "--as-is"
    proc = subprocess.run([sys.executable, "-c", LOAD_CHILD, str(site), "unused", mode],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert proc.stdout.strip() == str(prebuilt / _build.library_name("matmul"))
    assert os.listdir(cache) == [] and os.listdir(tmp_path / "tmp") == []
