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

import os
import shutil
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
