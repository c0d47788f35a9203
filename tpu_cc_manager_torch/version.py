"""Single source of version truth (build machinery reads this via
``python -c "from tpu_cc_manager_torch.version import __version__"``; the container
Makefile pins the same value in deployments/container/versions.mk, mirroring
the reference's versions.mk:15)."""

__version__ = "0.3.0"
