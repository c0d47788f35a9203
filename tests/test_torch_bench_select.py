"""The JAX suite of the bench harnesses' reporting rules, run on the port.

``tests/test_bench_select.py`` (``phase_accounting``,
``select_headline_smoke``, ``summarize_ab`` and ``mean_ci95``) runs through
``port_suite`` with its ``from bench import ...`` and ``from bench_ab import
...`` bound to the port's copies, ``tpu_cc_manager_torch.bench.bench`` and
``tpu_cc_manager_torch.bench.bench_ab``, and its ``"tpu"`` backend label read
as the port smoke's ``"cuda"``: the headline prefers the card's runs as the
reference prefers the TPU's. No case is dropped.
"""

from test_torch_fleet_sides import port_suite

port_suite(globals(), "test_bench_select",
           modules={"bench": "tpu_cc_manager_torch.bench.bench",
                    "bench_ab": "tpu_cc_manager_torch.bench.bench_ab"},
           strings={"tpu": "cuda"})


def test_the_suite_reads_the_port():
    assert select_headline_smoke.__module__ == "tpu_cc_manager_torch.bench.bench"  # noqa: F821
    assert summarize_ab.__module__ == "tpu_cc_manager_torch.bench.bench_ab"  # noqa: F821
