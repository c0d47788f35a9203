"""The port's control loop: reconciler, watch loop, CLI.

Copies of the JAX package's ``ccmanager/`` modules (the rolling
orchestrator and federation not yet), over the device layer ``gpudev``
through :mod:`tpu_cc_manager_torch.ccmanager.node`. Reference analogue:
main.py (CCManager, watch_and_apply, main(); SURVEY.md §2 #1-#4, §3).
"""

from tpu_cc_manager_torch.ccmanager.manager import CCManager

__all__ = ["CCManager"]
