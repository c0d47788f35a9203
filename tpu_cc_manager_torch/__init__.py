"""PyTorch/CUDA port of tpu_cc_manager's accelerator path for NVIDIA Hopper.

Laid out path for path like the JAX package (``ops/``, ``models/``,
``smoke/``, ``utils/``); it imports ``torch`` and never JAX or
``tpu_cc_manager``. Entry points run on the card unless the caller asks for
the CPU.
"""
