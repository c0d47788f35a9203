"""The port's deployment on NVIDIA H100 nodes, and a reader of its files.

- ``daemonset.yaml``: the agent's DaemonSet, ServiceAccount, ClusterRole
  and binding;
- ``Dockerfile``: the agent's image, with every kernel library prebuilt for
  ``sm_90a`` beside the package (``python -m tpu_cc_manager_torch.ops._build``);
- ``Makefile``: the image's build, push and test targets.

The readers take the manifest and the Dockerfile line by line, as
``lint/surface.py`` reads the manifest's env, so nothing here needs a YAML
parser. They read the layout these two files use (block lists of
``key: value`` items, one instruction per logical Dockerfile line), not YAML
or Dockerfile syntax at large. :func:`container_launch` turns them into the
command, environment and working directory the container's agent gets,
with the container's paths moved under a directory of the caller's: what
``chip_smoke.py`` and ``tests/test_torch_deploy.py`` start.

Imports nothing but the standard library.
"""

from __future__ import annotations

import json
import os
import pathlib
import shlex
import sys

DIR = pathlib.Path(__file__).resolve().parent
MANIFEST = DIR / "daemonset.yaml"
DOCKERFILE = DIR / "Dockerfile"
#: The manifest's mounts of the host's own device trees, which a started
#: agent reads as they are.
HOST_TREES = ("/dev", "/sys")


def _unquote(value: str) -> str:
    value = value.strip()
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
        return value[1:-1]
    return value


def list_items(text: str, key: str) -> list[dict[str, str]]:
    """The items of the first block list under ``key:``, each a dict of its
    ``key: value`` lines, nested keys flattened by their own name (a key
    with no scalar value maps to ``""``)."""
    lines = text.splitlines()
    start = next((i for i, line in enumerate(lines) if line.strip() == f"{key}:"), None)
    if start is None:
        return []
    indent = len(lines[start]) - len(lines[start].lstrip())
    items: list[dict[str, str]] = []
    for line in lines[start + 1:]:
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if len(line) - len(line.lstrip()) <= indent:
            break
        if stripped.startswith("- "):
            items.append({})
            stripped = stripped[2:]
        if items and ":" in stripped:
            name, _, value = stripped.partition(":")
            items[-1].setdefault(name.strip(), _unquote(value))
    return items


def env(text: str) -> dict[str, str | None]:
    """The container's env: name -> value, None where it comes from
    ``valueFrom`` (the downward API)."""
    return {item["name"]: (None if "valueFrom" in item else item.get("value", ""))
            for item in list_items(text, "env")}


def mounts(text: str) -> dict[str, str]:
    """The container's mounts: mount path -> volume name."""
    return {item["mountPath"]: item["name"] for item in list_items(text, "volumeMounts")}


def instructions(text: str) -> list[tuple[str, str, str]]:
    """Every Dockerfile instruction as ``(stage, INSTRUCTION, arguments)``,
    continuation lines joined and comments dropped; ``stage`` is the name
    of the ``FROM ... AS <name>`` it belongs to ("" before the first)."""
    out, stage, logical = [], "", ""
    for line in text.splitlines():
        stripped = line.strip()
        if not logical and (not stripped or stripped.startswith("#")):
            continue
        if stripped.endswith("\\"):
            logical += stripped[:-1] + " "
            continue
        logical += stripped
        word, _, args = logical.partition(" ")
        word, args = word.upper(), " ".join(args.split())
        if word == "FROM":
            parts = args.split()
            stage = parts[-1] if len(parts) >= 3 and parts[-2].upper() == "AS" else ""
        out.append((stage, word, args))
        logical = ""
    return out


def final_stage(text: str) -> str:
    return [stage for stage, word, _ in instructions(text) if word == "FROM"][-1]


def entrypoint(text: str) -> list[str]:
    """The image's ``ENTRYPOINT`` (exec form)."""
    return json.loads([a for _, w, a in instructions(text) if w == "ENTRYPOINT"][-1])


def image_env(text: str) -> dict[str, str]:
    """The final stage's ``ENV``, ``KEY=VALUE`` pairs."""
    stage = final_stage(text)
    out = {}
    for where, word, args in instructions(text):
        if where == stage and word == "ENV":
            for pair in shlex.split(args):
                name, _, value = pair.partition("=")
                out[name] = value
    return out


def copies(text: str) -> list[tuple[str, str | None, list[str], str]]:
    """Every ``COPY`` as ``(stage, --from stage or None, sources, dest)``."""
    out = []
    for stage, word, args in instructions(text):
        if word != "COPY":
            continue
        parts = args.split()
        flags = [p for p in parts if p.startswith("--")]
        paths = [p for p in parts if not p.startswith("--")]
        origin = next((f.split("=", 1)[1] for f in flags if f.startswith("--from=")), None)
        out.append((stage, origin, paths[:-1], paths[-1]))
    return out


def runs(text: str, stage: str | None = None) -> list[str]:
    """The ``RUN`` commands of ``stage`` (default: every stage)."""
    return [args for where, word, args in instructions(text)
            if word == "RUN" and (stage is None or where == stage)]


def package_dir(text: str) -> str:
    """Where the image puts the package: the destination of the ``COPY``
    of ``tpu_cc_manager_torch`` from the build context."""
    return next(dest for _, origin, sources, dest in copies(text)
                if origin is None and sources == ["tpu_cc_manager_torch"])


def prebuild_command(text: str) -> list[str]:
    """The image's kernel build, ``python -m tpu_cc_manager_torch.ops._build
    --dir DIR``, as an argument list."""
    for command in runs(text):
        for part in command.split("&&"):
            words = shlex.split(part)
            if words[1:3] == ["-m", "tpu_cc_manager_torch.ops._build"]:
                return words
    raise ValueError("the Dockerfile runs no python -m tpu_cc_manager_torch.ops._build")


def prebuild_dir(text: str) -> str:
    words = prebuild_command(text)
    return words[words.index("--dir") + 1]


def host_path(path: str, mount_paths, root: pathlib.Path, app_dir: str,
              app: pathlib.Path) -> str:
    """A container ``path`` on this host: under ``app`` for the image's
    package directory, under ``root`` for a mounted path (``HOST_TREES``
    stay the host's own), else as it is."""
    for prefix, base in [(app_dir, app)] + [(m, None) for m in sorted(mount_paths, key=len,
                                                                     reverse=True)]:
        if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
            if prefix in HOST_TREES:
                return path
            if base is None:
                return str(root / path.lstrip("/"))
            return str(base / os.path.relpath(path, prefix))
    return path


def container_launch(root: pathlib.Path, app: pathlib.Path, node_name: str) -> dict:
    """How the container runs the agent, on this host: ``cmd`` (the
    image's entrypoint with this interpreter), ``env`` (this process's,
    less any ``CC_*``, ``GPU_CC_*``, ``TPU_CC_*`` and ``PYTHONPATH``, then
    the image's ``ENV``, then the manifest's env, ``NODE_NAME`` as
    ``node_name``), ``cwd`` (``app``, the image's package directory's
    parent) and ``paths`` (each container path of the env -> its place
    here). The package is expected at ``app`` as the image has it; every
    mounted directory is created under ``root``."""
    manifest, dockerfile = MANIFEST.read_text(), DOCKERFILE.read_text()
    app_dir = os.path.dirname(package_dir(dockerfile))
    mount_paths = list(mounts(manifest))
    for mount in mount_paths:
        if mount not in HOST_TREES:
            (root / mount.lstrip("/")).mkdir(parents=True, exist_ok=True)
    environment = {k: v for k, v in os.environ.items()
                   if not k.startswith(("CC_", "GPU_CC_", "TPU_CC_")) and k != "PYTHONPATH"}
    paths = {}
    for name, value in [*image_env(dockerfile).items(), *env(manifest).items()]:
        if value is None:
            value = node_name
        elif "$" in value:  # PATH=/opt/venv/bin:$PATH: the venv is this interpreter
            continue
        elif value.startswith("/"):
            paths[value] = host_path(value, mount_paths, root, app_dir, app)
            value = paths[value]
        environment[name] = value
    cmd = entrypoint(dockerfile)
    if cmd[0] == "python":
        cmd = [sys.executable, *cmd[1:]]
    return {"cmd": cmd, "env": environment, "cwd": str(app), "paths": paths}
