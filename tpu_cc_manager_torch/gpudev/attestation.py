"""Attestation quotes of H100 nodes: nonces, verification, transport.

Port of ``tpu_cc_manager/tpudev/attestation.py``: ``fresh_nonce``,
``quote_problems``, ``verify_quote``, ``serialize_quote``,
``deserialize_quote`` and ``quote_digest`` behave as the JAX functions do
and give the same bytes for the same fields, so the peers of a mixed pool
verify each other. Verifiers by quote ``platform``:

- ``fake`` — the JAX fake's HMAC (gpudev/fake.py), admitted only when the
  caller allows fake quotes;
- ``h100`` — the GPUs' own evidence from NVML (gpudev/h100.py). For each
  GPU: the nonce-derived challenge sits in the report's signed request;
  the report's ECDSA P-384 signature verifies under the leaf key of its
  attestation certificate chain; each certificate verifies under its
  parent, up to the root certificate file the operator supplies
  (``CC_NVIDIA_ROOT_CERT_FILE``). No root is vendored or fetched: without
  one the check fails closed. The report's measurements are compared
  across the pool through ``runtime_digest``, not against NVIDIA's golden
  values (reference integrity manifests), which are not in this
  repository.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import logging
import os
import secrets
from dataclasses import dataclass

from tpu_cc_manager_torch.gpudev import ecdsa
from tpu_cc_manager_torch.gpudev.contract import AttestationQuote, GpuError
from tpu_cc_manager_torch.gpudev.fake import sign_fake_quote

log = logging.getLogger(__name__)

REQUIRED_MEASUREMENTS = ("accelerator_type", "runtime_digest", "cc_mode")
ROOT_CERT_ENV = "CC_NVIDIA_ROOT_CERT_FILE"


class AttestationError(GpuError):
    """Quote failed verification (fatal outside devtools policy)."""


def fresh_nonce() -> str:
    return secrets.token_hex(16)


def nonce_challenge(nonce: str) -> bytes:
    """The 32 bytes a device signs for ``nonce``: the JAX package's
    configfs-tsm challenge (tpudev/attestation.py)."""
    return hashlib.sha256(f"tpu-cc-manager/{nonce}".encode()).digest()


# ---- the H100 SPDM report ------------------------------------------------------
#
# NVML returns the SPDM GET_MEASUREMENTS request the driver sent and the
# MEASUREMENTS response, back to back; the signature (raw r || s, P-384)
# closes the response and covers every byte before it.
#   request:  version, code 0xE0, param1, param2, nonce[32], slot     (37 bytes)
#   response: version, code 0x60, param1, param2, blocks, record length
#             (3 bytes, little endian), record, nonce[32], opaque length
#             (2 bytes, little endian), opaque data, signature[96]
SPDM_GET_MEASUREMENTS = 0xE0
SPDM_MEASUREMENTS = 0x60
REQUEST_LEN = 37
SIGNATURE_LEN = 2 * ecdsa.COORD_BYTES


@dataclass(frozen=True)
class SpdmReport:
    request_nonce: bytes
    measurement_record: bytes
    signed: bytes
    signature: tuple[int, int]


def parse_spdm_report(report: bytes) -> SpdmReport:
    """Split an H100 attestation report; raises AttestationError when it
    is not shaped as above."""
    if len(report) < REQUEST_LEN + 8 + 32 + 2 + SIGNATURE_LEN:
        raise AttestationError(f"attestation report too short ({len(report)} bytes)")
    if report[1] != SPDM_GET_MEASUREMENTS or report[REQUEST_LEN + 1] != SPDM_MEASUREMENTS:
        raise AttestationError("attestation report is not an SPDM measurements exchange")
    resp = report[REQUEST_LEN:]
    record_len = int.from_bytes(resp[5:8], "little")
    record_end = 8 + record_len
    opaque_at = record_end + 32
    if opaque_at + 2 > len(resp):
        raise AttestationError("attestation report's measurement record overruns it")
    opaque_len = int.from_bytes(resp[opaque_at:opaque_at + 2], "little")
    if opaque_at + 2 + opaque_len + SIGNATURE_LEN != len(resp):
        raise AttestationError("attestation report's lengths do not add up")
    return SpdmReport(request_nonce=report[4:36], measurement_record=resp[8:record_end],
                      signed=report[:-SIGNATURE_LEN],
                      signature=ecdsa.raw_signature(report[-SIGNATURE_LEN:]))


def runtime_digest(driver_version: str, vbios_version: str, records: list[bytes]) -> str:
    """The pool-comparable digest of what the GPUs run: the driver and
    VBIOS versions and each report's measurement block, in PCI order."""
    h = hashlib.sha256()
    for part in (driver_version.encode(), vbios_version.encode(), *records):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.hexdigest()


def load_root(path: str | None = None) -> ecdsa.Certificate | None:
    """The operator's root certificate (PEM or DER), or None when none is
    configured or it cannot be read."""
    path = path or os.environ.get(ROOT_CERT_ENV)
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            certs = ecdsa.split_certificates(f.read())
        return ecdsa.parse_certificate(certs[0]) if certs else None
    except (OSError, ecdsa.EcdsaError) as e:
        log.error("root certificate %s unusable: %s", path, e)
        return None


def h100_evidence_problems(quote, root: ecdsa.Certificate | None) -> list[str]:
    """The ``h100`` checks on one quote (any object with the quote's
    fields, the JAX ``AttestationQuote`` too)."""
    if root is None:
        return [f"no NVIDIA root certificate (set {ROOT_CERT_ENV}); failing closed"]
    try:
        evidence = json.loads(quote.signature)
        if not isinstance(evidence, list) or not evidence:
            raise ValueError("no GPU evidence")
        gpus = [(str(e["bdf"]), base64.b64decode(e["report"], validate=True),
                 base64.b64decode(e["certs"], validate=True)) for e in evidence]
    except (ValueError, KeyError, TypeError, binascii.Error) as e:
        return [f"h100 quote evidence undecodable: {e}"]
    challenge = nonce_challenge(quote.nonce)
    problems, records = [], []
    for bdf, report, certs in gpus:
        try:
            spdm = parse_spdm_report(report)
            records.append(spdm.measurement_record)
            if not hmac.compare_digest(spdm.request_nonce, challenge):
                problems.append(f"{bdf}: report is not bound to this nonce")
                continue
            chain = [ecdsa.parse_certificate(der) for der in ecdsa.split_certificates(certs)]
            if not chain:
                raise ecdsa.EcdsaError("no certificate in the attestation chain")
            ecdsa.verify(chain[0].public_key, spdm.signed, *spdm.signature)
            ecdsa.verify_chain(chain, root)
        except (AttestationError, ecdsa.EcdsaError) as e:
            problems.append(f"{bdf}: {e}")
    m = quote.measurements
    if not problems and m.get("runtime_digest") != runtime_digest(
            m.get("driver_version", ""), m.get("vbios_version", ""), records):
        problems.append("runtime_digest does not match the reports' measurement blocks")
    return problems


def check_h100_signature(quote) -> list[str]:
    return h100_evidence_problems(quote, load_root())


def _check_fake_signature(quote) -> list[str]:
    expected = sign_fake_quote(quote.slice_id, quote.nonce, quote.mode, quote.measurements)
    if not hmac.compare_digest(expected, quote.signature):
        return ["fake quote HMAC mismatch"]
    return []


_SIGNATURE_CHECKS = {
    "fake": _check_fake_signature,
    "h100": check_h100_signature,
}


def _check_tsm_binding(quote: AttestationQuote, nonce: str) -> list[str]:
    """A quote that claims a TEE guest report must carry one holding the
    nonce-derived challenge (the JAX check, for quotes of mixed pools)."""
    provider = quote.measurements.get("tsm_provider", "none")
    if provider in ("none", "unavailable"):
        return []
    outblob_b64 = quote.host_evidence.get("tsm_outblob_b64")
    if not outblob_b64:
        return [f"tsm_provider={provider!r} claimed but no guest report attached"]
    try:
        outblob = base64.b64decode(outblob_b64, validate=True)
    except (ValueError, binascii.Error):
        return ["tsm guest report is not valid base64"]
    if nonce_challenge(nonce) not in outblob:
        return ["tsm report is not bound to this nonce (nonce-derived challenge "
                "not present in the signed report_data)"]
    return []


def quote_problems(
    quote: AttestationQuote,
    nonce: str,
    expected_mode: str,
    expected_slice_id: str | None = None,
    allow_fake: bool = False,
) -> list[str]:
    """Every check of :func:`verify_quote` as a problem list."""
    problems: list[str] = []
    if quote.platform == "fake" and not allow_fake:
        problems.append("fake-platform quote rejected: the fake device layer is not in use")
    if quote.nonce != nonce:
        problems.append(f"nonce mismatch: sent {nonce}, quote has {quote.nonce}")
    if quote.mode != expected_mode:
        problems.append(f"mode mismatch: expected {expected_mode}, quote says {quote.mode}")
    if expected_slice_id is not None and quote.slice_id != expected_slice_id:
        problems.append(f"slice mismatch: expected {expected_slice_id}, quote says {quote.slice_id}")
    for key in REQUIRED_MEASUREMENTS:
        if key not in quote.measurements:
            problems.append(f"missing measurement {key!r}")
    problems.extend(_check_tsm_binding(quote, nonce))
    checker = _SIGNATURE_CHECKS.get(quote.platform)
    if checker is None:
        problems.append(f"unknown quote platform {quote.platform!r}")
    else:
        problems.extend(checker(quote))
    return problems


def verify_quote(
    quote: AttestationQuote,
    nonce: str,
    expected_mode: str,
    expected_slice_id: str | None = None,
    debug_policy: bool = False,
    allow_fake: bool = False,
) -> list[str]:
    """The problem list; AttestationError on any problem unless
    ``debug_policy`` (devtools), which logs them instead."""
    problems = quote_problems(quote, nonce, expected_mode,
                              expected_slice_id=expected_slice_id, allow_fake=allow_fake)
    if problems and not debug_policy:
        raise AttestationError("; ".join(problems))
    for p in problems:
        log.warning("attestation (devtools policy, non-fatal): %s", p)
    return problems


def serialize_quote(quote: AttestationQuote) -> str:
    """Compact JSON of the whole quote, signature included."""
    return json.dumps(
        {
            "slice_id": quote.slice_id,
            "nonce": quote.nonce,
            "mode": quote.mode,
            "measurements": quote.measurements,
            "signature": quote.signature,
            "platform": quote.platform,
            "host_evidence": quote.host_evidence,
        },
        sort_keys=True, separators=(",", ":"),
    )


def deserialize_quote(data: str) -> AttestationQuote:
    """Inverse of :func:`serialize_quote`; AttestationError on any shape
    problem."""
    try:
        obj = json.loads(data)
        return AttestationQuote(
            slice_id=str(obj["slice_id"]),
            nonce=str(obj["nonce"]),
            mode=str(obj["mode"]),
            measurements={str(k): str(v) for k, v in obj["measurements"].items()},
            signature=str(obj["signature"]),
            platform=str(obj["platform"]),
            host_evidence={str(k): str(v) for k, v in (obj.get("host_evidence") or {}).items()},
        )
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise AttestationError(f"undeserializable quote: {e}") from e


def quote_digest(quote: AttestationQuote) -> str:
    """The pool-wide "same runtime, same mode" fingerprint (node id left
    out), as the JAX function computes it."""
    msg = json.dumps({"mode": quote.mode, "m": quote.measurements}, sort_keys=True).encode()
    return hashlib.sha256(msg).hexdigest()[:16]
