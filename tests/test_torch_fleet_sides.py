"""The JAX fleet rollout suites, run on the port.

The JAX suites of the fleet rollout (``obs/slo``, ``obs/flight``,
``obs/failslow``, ``faults``, ``drain/sim``, ``ccmanager/rollout_state``,
``ccmanager/rolling`` and ``serve``) and of the operator's modules
(``ccmanager/federation``, ``obs/fleet``, ``ctl``, ``lint``) run on the
port through
:func:`port_suite`: each ``tests/test_torch_<suite>.py`` executes the JAX
file ``tests/test_<suite>.py`` itself, with every import from
``tpu_cc_manager`` read from ``tpu_cc_manager_torch``, so the port is held
to the JAX test's own inputs, bounds and tolerances and the two cannot
drift. The JAX side is the JAX file, collected on its own;
``test_torch_fleet_parity.py`` runs both packages side by side.

The device layers differ. Where a JAX suite builds ``FakeTpuBackend``, the
port's side builds :class:`FakeNode`: the port's ``NodeBackend`` over an
HGX-style ``FakeGpuBackend``, as the port's agent and serving harness build
it, with the fake's test controls (``fail_next``, ``healthy``,
``set_preempted``, ``op_log``, ...) reachable on the node and ``committed``
read in label modes.
"""

import ast
import pathlib

import pytest
from _pytest.assertion.rewrite import rewrite_asserts

from tpu_cc_manager_torch.ccmanager.node import NodeBackend, to_gpu_mode, to_label_mode
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
from tpu_cc_manager_torch.kubeclient.fake import FakeKube

TESTS = pathlib.Path(__file__).resolve().parent

#: Imports a JAX suite makes that the port answers with a name of its own.
SEAMS = {("tpu_cc_manager.tpudev.fake", "FakeTpuBackend"): (__name__, "FakeNode"),
         ("tpu_cc_manager.tpudev.fake", "sign_fake_quote"):
             ("tpu_cc_manager_torch.gpudev.fake", "sign_fake_quote"),
         ("tpu_cc_manager.tpudev", "attestation"): ("tpu_cc_manager_torch.gpudev", "attestation"),
         ("tpu_cc_manager.tpudev.contract", "SliceTopology"):
             ("tpu_cc_manager_torch.ccmanager.node", "SliceView")}
#: JAX modules whose port lives under another path: every name a suite
#: imports from one (at the top or inside a test) is read from the port's.
SEAM_MODULES = {"tpu_cc_manager.tpudev.attestation": "tpu_cc_manager_torch.gpudev.attestation"}
#: A JAX package path and its port's, for suites that name files of the
#: package in strings (``paths=True``); the longest prefix first. The JAX
#: agent's DaemonSet manifest is the H100 one's counterpart.
PATHS = (("tpu_cc_manager/tpudev/", "tpu_cc_manager_torch/gpudev/"),
         ("tpu_cc_manager/", "tpu_cc_manager_torch/"),
         ("deployments/manifests/daemonset.yaml", "tpu_cc_manager_torch/deploy/daemonset.yaml"))


class FakeNode(NodeBackend):
    """The port's fake node as the JAX suites drive ``FakeTpuBackend``: the
    GPUs are the chips; the fake's controls and state pass through. A
    one-host slice is the node of the same name; each host of a slice of
    several is a node of its own (``<slice>-host-<i>``) in that slice."""

    _OWN = ("gpu", "state_dir", "_devices")
    def __init__(self, num_chips: int = 4, accelerator_type: str = "h100-sxm",
                 slice_id: str = "fake-node-0", num_hosts: int = 1, host_index: int = 0,
                 **kwargs) -> None:
        node_id = slice_id if num_hosts == 1 else f"{slice_id}-host-{host_index}"
        if "initial_mode" in kwargs:  # a label mode: ``slice`` is the fake's ``ppcie``
            kwargs["initial_mode"] = to_gpu_mode(kwargs["initial_mode"])
        slice_cc = kwargs.pop("slice_cc_supported", None)
        if slice_cc is not None:
            # A chip's slice-CC support is its GPU's PPCIe support; the
            # NVSwitches support it.
            kwargs["ppcie_supported"] = (
                list(slice_cc) + [True] * kwargs.get("num_switches", 4)
                if isinstance(slice_cc, (list, tuple)) else slice_cc)
        super().__init__(FakeGpuBackend(num_gpus=num_chips, node_id=node_id,
                                        num_hosts=num_hosts, host_index=host_index,
                                        slice_id=slice_id, **kwargs))

    def __getattr__(self, name):
        return getattr(self.__dict__["gpu"], name)

    def __setattr__(self, name, value) -> None:
        # The fake's state (``healthy``, ``fail``, ...) is set on the fake;
        # anything else (a test's stand-in for a method) on the node.
        if name not in self._OWN and name in vars(self.gpu):
            setattr(self.gpu, name, value)
        else:
            object.__setattr__(self, name, value)

    @property
    def committed(self) -> dict[int, str]:
        """Each GPU's committed mode, by index, in label modes. Read from
        the fake's state, as the JAX fake's ``committed`` is: no contract
        call, so a fault armed for the manager stays armed."""
        return {d.index: to_label_mode(self.gpu._mode_of(d.index))
                for d in self.gpu._topology.devices}


def _port_import(node: ast.ImportFrom) -> list[ast.ImportFrom]:
    """``node`` read from the port: the seam names from their own module,
    everything else from ``tpu_cc_manager_torch``."""
    module = node.module or ""
    if module != "tpu_cc_manager" and not module.startswith("tpu_cc_manager."):
        return [node]
    if module in SEAM_MODULES:
        return [ast.copy_location(ast.ImportFrom(SEAM_MODULES[module], node.names, 0), node)]
    kept, seams = [], []
    for alias in node.names:
        seam = SEAMS.get((module, alias.name))
        if seam is None:
            kept.append(alias)
        else:
            seams.append(ast.ImportFrom(seam[0], [ast.alias(seam[1], alias.asname or alias.name)],
                                        0))
    port = "tpu_cc_manager_torch" + module[len("tpu_cc_manager"):]
    out = [ast.ImportFrom(port, kept, 0)] if kept else []
    return [ast.copy_location(n, node) for n in out + seams]


def port_path(text: str) -> str:
    """A path of the JAX package as the port's (other strings as they are)."""
    for jax_prefix, port_prefix in PATHS:
        if text.startswith(jax_prefix):
            return port_prefix + text[len(jax_prefix):]
    return text


class _ToPort(ast.NodeTransformer):
    def __init__(self, paths: bool, modules: dict[str, str], strings: dict[str, str]) -> None:
        self.paths, self.modules, self.strings = paths, modules, strings

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module in self.modules:
            node.module = self.modules[node.module]
            return node
        return _port_import(node)

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name in self.modules:
                alias.asname, alias.name = alias.asname or alias.name, self.modules[alias.name]
            elif alias.name.split(".")[0] == "tpu_cc_manager":
                raise ValueError(f"line {node.lineno}: import {alias.name} has no port form")
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            if self.paths:
                node.value = port_path(node.value)
            for old, new in self.strings.items():
                node.value = node.value.replace(old, new)
        return node


def port_suite(namespace: dict, suite: str, drop: tuple[str, ...] = (), paths: bool = False,
               modules: dict[str, str] | None = None,
               strings: dict[str, str] | None = None) -> None:
    """Run ``tests/<suite>.py`` into ``namespace`` (the calling test
    module's globals) with its imports read from the port. ``drop`` names
    top-level definitions and imported names to leave out; each must
    exist, so a renamed JAX case fails here instead of running nowhere.
    ``paths`` reads every string that starts with a path of the JAX
    package as the port's path (:data:`PATHS`); ``modules`` binds a plain
    ``import <name>``, and ``from <name> import ...`` (at the top or inside
    a test), to a module of the port instead; ``strings`` replaces
    text in every string constant (code a suite runs in a child process).
    Assertions are rewritten as pytest rewrites a test module's, and tracebacks point at
    the JAX file's lines."""
    path = TESTS / f"{suite}.py"
    source = path.read_bytes()
    tree = ast.parse(source, filename=str(path))
    body, found = [], set()
    for node in tree.body:
        name = getattr(node, "name", None)
        if name in drop:
            found.add(name)
            continue
        if isinstance(node, ast.ImportFrom):
            names = [a for a in node.names if (a.asname or a.name) not in drop]
            found.update((a.asname or a.name) for a in node.names if a not in names)
            if not names:
                continue
            node.names = names
        body.append(node)
    missing = set(drop) - found
    if missing:
        raise ValueError(f"{suite} has no top-level {sorted(missing)}")
    tree.body = body
    tree = ast.fix_missing_locations(
        _ToPort(paths, modules or {}, strings or {}).visit(tree))
    rewrite_asserts(tree, source, str(path))
    exec(compile(tree, str(path), "exec"), namespace)


@pytest.fixture()
def fake_kube():
    """The port's ``FakeKube`` (the conftest one is the JAX package's)."""
    return FakeKube()


@pytest.fixture()
def fake_tpu():
    """The port's fake node (the conftest one is the JAX package's
    ``FakeTpuBackend``)."""
    return FakeNode()


def test_port_suite_reads_the_port():
    ns = {"__name__": "port_suite_probe"}
    port_suite(ns, "test_rollout_resume", drop=("federation_mod", "_run_crash_resume"))
    assert ns["RollingReconfigurator"].__module__ == "tpu_cc_manager_torch.ccmanager.rolling"
    assert ns["rollout_state"].__name__ == "tpu_cc_manager_torch.ccmanager.rollout_state"
    assert "federation_mod" not in ns and "_run_crash_resume" not in ns
    assert ns["test_record_round_trip"].__code__.co_filename == str(TESTS / "test_rollout_resume.py")
    ns = {"__name__": "port_suite_probe"}
    port_suite(ns, "test_chaos")
    assert ns["FakeTpuBackend"] is FakeNode
    with pytest.raises(ValueError, match="no top-level"):
        port_suite({"__name__": "port_suite_probe"}, "test_slo", drop=("test_gone",))


def test_port_suite_reads_paths_and_binds_modules():
    """``paths`` maps the JAX package's path literals to the port's (the
    device layer's too) and leaves other strings alone; ``modules`` binds a
    plain import to a module of the port."""
    assert port_path("tpu_cc_manager/ctl.py") == "tpu_cc_manager_torch/ctl.py"
    assert port_path("tpu_cc_manager/tpudev/impl.py") == "tpu_cc_manager_torch/gpudev/impl.py"
    assert port_path("deployments/manifests/daemonset.yaml") == \
        "tpu_cc_manager_torch/deploy/daemonset.yaml"
    for text in ("tests/test_x.py", "cclint (tpu_cc_manager/lint/)", "tpu_cc_manager.ctl"):
        assert port_path(text) == text
    ns = {"__name__": "port_suite_probe", "__file__": __file__}
    port_suite(ns, "test_cclint", paths=True)
    assert ns["surface"].__name__ == "tpu_cc_manager_torch.lint.surface"
    ns = {"__name__": "port_suite_probe", "__file__": __file__}
    port_suite(ns, "test_metrics_lint",
               modules={"check_metrics_lint": "tpu_cc_manager_torch.lint.expo"})
    assert ns["check_metrics_lint"].__name__ == "tpu_cc_manager_torch.lint.expo"
    ns = {"__name__": "port_suite_probe", "__file__": __file__}
    port_suite(ns, "test_metrics_lint")  # unbound: the JAX shim, as the JAX suite runs it
    assert ns["check_metrics_lint"].lint.__module__ == "tpu_cc_manager.lint.expo"


def test_the_fake_node_passes_the_fakes_controls_through():
    node = FakeNode(num_chips=2, slice_id="s0", reset_latency_s=0.0)
    topo = node.discover()
    assert (topo.slice_id, len(topo.chips), topo.num_hosts) == ("s0", 2, 1)
    node.healthy = False
    assert node.gpu.healthy is False and node.probe_runtime_health().healthy is False
    node.fail_next("stage")
    with pytest.raises(Exception, match="injected fault in stage"):
        node.stage_cc_mode(topo.chips, "on")
    node.stage_cc_mode(topo.chips, "slice")
    node.reset(topo.chips)
    assert node.committed == {0: "slice", 1: "slice"}
    host = FakeNode(num_chips=2, num_hosts=2, host_index=1, slice_id="s1").discover()
    assert (host.slice_id, host.num_hosts, host.host_index, host.is_multi_host) == \
        ("s1", 2, 1, True)


def test_committed_reads_the_fake_without_spending_a_fault():
    """A fault armed for the manager's next ``discover`` stays armed when a
    test reads ``committed``."""
    node = FakeNode(num_chips=2)
    node.fail_next("discover")
    assert node.committed == {0: "off", 1: "off"}
    with pytest.raises(Exception, match="injected fault in discover"):
        node.discover()


def test_port_suite_reads_a_seam_module_inside_a_test_too():
    """``from tpu_cc_manager.tpudev.attestation import ...`` inside a test's
    body (test_multislice's) reads the port's ``gpudev/attestation``."""
    imported = {}
    node = ast.parse("def probe():\n    from tpu_cc_manager.tpudev.attestation import quote_digest\n"
                     "    return quote_digest\n")
    exec(compile(ast.fix_missing_locations(_ToPort(False, {}, {}).visit(node)), "<probe>",
                 "exec"), imported)
    assert imported["probe"]().__module__ == "tpu_cc_manager_torch.gpudev.attestation"
