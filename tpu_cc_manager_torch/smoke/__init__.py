"""Verify-phase smoke workloads of the port (``python -m tpu_cc_manager_torch.smoke``)."""
