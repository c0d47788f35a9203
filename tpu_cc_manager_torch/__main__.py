"""``python -m tpu_cc_manager_torch`` runs the port's node agent (the port
of ``python -m tpu_cc_manager``; reference analogue: ``python3
/app/main.py``, Dockerfile.distroless:70)."""

import sys

from tpu_cc_manager_torch.ccmanager.cli import main

if __name__ == "__main__":
    sys.exit(main())
