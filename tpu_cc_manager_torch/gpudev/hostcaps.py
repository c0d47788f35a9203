"""Host confidential-computing capability detection.

Port of ``tpu_cc_manager/ccmanager/hostcaps.py``: the reference's
is_host_cc_enabled() (main.py:80-103) probes the KVM TDX and SEV-SNP host
parameters; inside a confidential VM the guest device nodes answer the same
question.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

# (description, path, expected-content prefix or None for existence-only)
DEFAULT_PROBES: tuple[tuple[str, str, str | None], ...] = (
    ("TDX guest device", "/dev/tdx_guest", None),
    ("SEV guest device", "/dev/sev-guest", None),
    ("KVM Intel TDX host support", "/sys/module/kvm_intel/parameters/tdx", "Y"),
    ("KVM AMD SEV-SNP host support", "/sys/module/kvm_amd/parameters/sev_snp", "Y"),
)


def is_host_cc_enabled(
    probes: tuple[tuple[str, str, str | None], ...] = DEFAULT_PROBES,
) -> bool:
    """True if any probe indicates confidential-computing capability."""
    for desc, path, expect in probes:
        if not os.path.exists(path):
            continue
        if expect is None:
            log.info("host CC capability: %s present (%s)", desc, path)
            return True
        try:
            with open(path, "r", encoding="utf-8") as f:
                content = f.read().strip()
        except OSError as e:
            log.debug("probe %s unreadable: %s", path, e)
            continue
        if content.upper().startswith(expect.upper()):
            log.info("host CC capability: %s enabled (%s=%s)", desc, path, content)
            return True
    log.warning("no host CC capability detected (probed %d locations)", len(probes))
    return False
