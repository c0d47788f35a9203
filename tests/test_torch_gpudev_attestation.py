"""The H100 quote verifier (tpu_cc_manager_torch/gpudev/attestation.py,
ecdsa.py) and its byte-compatibility with the JAX package's quotes.

The verifier is pure stdlib; these tests make a throwaway P-384 root ->
device CA -> attestation-key chain and SPDM-shaped reports with the
``cryptography`` package (test-only, as tests/test_attestation_sig.py
uses it), then show a sound quote passes and every tampered one fails
closed."""

import base64
import dataclasses
import datetime
import json
import os

import pytest

pytest.importorskip("cryptography")  # optional dep: P-384 keys and certificates for the chain

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, utils
from cryptography.x509.oid import NameOID

from test_torch_gpudev_real import GPU_BDFS, Rig
from tpu_cc_manager.tpudev import attestation as jax_attestation
from tpu_cc_manager.tpudev.contract import AttestationQuote as JaxQuote
from tpu_cc_manager_torch.gpudev import attestation, ecdsa
from tpu_cc_manager_torch.gpudev.contract import MODE_ON, AttestationQuote
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend


def _name(cn):
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _cert(subject, subject_key, issuer, issuer_key, ca=True):
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    return (x509.CertificateBuilder().subject_name(_name(subject)).issuer_name(_name(issuer))
            .public_key(subject_key.public_key()).serial_number(x509.random_serial_number())
            .not_valid_before(now).not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=ca, path_length=None), critical=True)
            .sign(issuer_key, hashes.SHA384()))


def _pem(cert):
    return cert.public_bytes(serialization.Encoding.PEM)


class Signer:
    """A GPU's attestation key and certificate chain under a test root;
    ``signer(nonce) -> (report, certs)`` as NVML returns them."""

    def __init__(self, root_cn="Test NVIDIA Device Identity CA"):
        self.root_key = ec.generate_private_key(ec.SECP384R1())
        self.root = _cert(root_cn, self.root_key, root_cn, self.root_key)
        ca_key = ec.generate_private_key(ec.SECP384R1())
        self.ca = _cert("Test GH100 Device CA", ca_key, root_cn, self.root_key)
        self.key = ec.generate_private_key(ec.SECP384R1())
        self.leaf = _cert("Test GH100 Attestation Key", self.key, "Test GH100 Device CA",
                          ca_key, ca=False)
        self.certs = _pem(self.leaf) + _pem(self.ca)
        self.record = bytes(range(1, 65)) * 3  # a measurement record of 192 bytes
        self.flip_at = None

    def report(self, nonce: bytes) -> bytes:
        request = bytes([0x11, 0xE0, 0x01, 0xFF]) + nonce + b"\x00"
        response = (bytes([0x11, 0x60, 0x00, 0x00, 0x01]) + len(self.record).to_bytes(3, "little")
                    + self.record + os.urandom(32) + (4).to_bytes(2, "little") + b"opaq")
        der = self.key.sign(request + response, ec.ECDSA(hashes.SHA384()))
        r, s = utils.decode_dss_signature(der)
        return request + response + r.to_bytes(48, "big") + s.to_bytes(48, "big")

    def __call__(self, nonce: bytes):
        return self.report(nonce), self.certs

    def write_root(self, path):
        path.write_bytes(_pem(self.root))
        return str(path)


@pytest.fixture(scope="module")
def signer():
    return Signer()


def h100_quote(signer, nonce="nonce-a", report=None, certs=None):
    report = report if report is not None else signer.report(attestation.nonce_challenge(nonce))
    record = attestation.parse_spdm_report(report).measurement_record
    evidence = [{"bdf": GPU_BDFS[0], "report": base64.b64encode(report).decode(),
                 "certs": base64.b64encode(certs if certs is not None else signer.certs).decode()}]
    measurements = {"accelerator_type": "h100-sxm", "num_gpus": "1", "cc_mode": MODE_ON,
                    "driver_version": "580.159.03", "vbios_version": "96.00.DA.00.0C",
                    "runtime_digest": attestation.runtime_digest(
                        "580.159.03", "96.00.DA.00.0C", [record])}
    return AttestationQuote(slice_id="h100-node-0", nonce=nonce, mode=MODE_ON,
                            measurements=measurements, platform="h100",
                            signature=json.dumps(evidence, sort_keys=True, separators=(",", ":")))


def test_a_sound_quote_passes(signer, tmp_path, monkeypatch):
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, signer.write_root(tmp_path / "root.pem"))
    quote = h100_quote(signer)
    assert attestation.verify_quote(quote, "nonce-a", MODE_ON, "h100-node-0") == []
    # The root as DER works too, and a chain that carries the root itself.
    der = tmp_path / "root.der"
    der.write_bytes(signer.root.public_bytes(serialization.Encoding.DER))
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, str(der))
    with_root = h100_quote(signer, certs=signer.certs + _pem(signer.root))
    assert attestation.verify_quote(with_root, "nonce-a", MODE_ON) == []


def _flipped(signer, at):
    report = bytearray(signer.report(attestation.nonce_challenge("nonce-a")))
    report[at] ^= 0x01
    return bytes(report)


@pytest.mark.parametrize("case,expect", [
    ("wrong nonce", "report is not bound to this nonce"),
    ("flipped measurement byte", "signature does not verify"),
    ("flipped signature byte", "signature does not verify"),
    ("foreign root", "signature does not verify"),
    ("truncated certificate", "truncated"),
    ("missing root file", "no NVIDIA root certificate"),
    ("forged digest", "runtime_digest does not match"),
    ("not a report", "not an SPDM measurements exchange"),
])
def test_tampered_quotes_fail_closed(signer, tmp_path, monkeypatch, case, expect):
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, signer.write_root(tmp_path / "root.pem"))
    quote = h100_quote(signer)
    if case == "wrong nonce":
        quote = h100_quote(signer, report=signer.report(attestation.nonce_challenge("nonce-b")))
    elif case == "flipped measurement byte":
        quote = h100_quote(signer, report=_flipped(signer, 37 + 8 + 5))
    elif case == "flipped signature byte":
        quote = h100_quote(signer, report=_flipped(signer, -3))
    elif case == "foreign root":
        # The same subject name under another key: only the signature can tell.
        monkeypatch.setenv(attestation.ROOT_CERT_ENV,
                           Signer().write_root(tmp_path / "foreign.pem"))
    elif case == "truncated certificate":
        quote = h100_quote(signer, certs=signer.leaf.public_bytes(serialization.Encoding.DER)[:-9])
    elif case == "missing root file":
        monkeypatch.setenv(attestation.ROOT_CERT_ENV, str(tmp_path / "absent.pem"))
    elif case == "forged digest":
        quote = dataclasses.replace(quote, measurements={**quote.measurements,
                                                         "runtime_digest": "0" * 64})
    elif case == "not a report":
        quote = dataclasses.replace(quote, signature=json.dumps([{
            "bdf": GPU_BDFS[0], "certs": "", "report": base64.b64encode(bytes(300)).decode()}]))
    problems = attestation.quote_problems(quote, "nonce-a", MODE_ON)
    assert problems and expect in "; ".join(problems), problems
    with pytest.raises(attestation.AttestationError):
        attestation.verify_quote(quote, "nonce-a", MODE_ON)


def test_no_root_configured_fails_closed(signer, monkeypatch):
    monkeypatch.delenv(attestation.ROOT_CERT_ENV, raising=False)
    assert attestation.check_h100_signature(h100_quote(signer)) == [
        f"no NVIDIA root certificate (set {attestation.ROOT_CERT_ENV}); failing closed"]


def test_ecdsa_against_cryptography(signer):
    assert ecdsa.on_curve(ecdsa.G)
    msg = b"the measured bytes"
    r, s = utils.decode_dss_signature(signer.key.sign(msg, ec.ECDSA(hashes.SHA384())))
    leaf = ecdsa.parse_certificate(signer.leaf.public_bytes(serialization.Encoding.DER))
    ecdsa.verify(leaf.public_key, msg, r, s)
    for bad in ((leaf.public_key, msg + b"!", r, s), (leaf.public_key, msg, s, r),
                (leaf.public_key, msg, 0, s), ((leaf.public_key[0], 1), msg, r, s)):
        with pytest.raises(ecdsa.EcdsaError):
            ecdsa.verify(*bad)
    rsa_like = ec.generate_private_key(ec.SECP256R1())
    p256 = _cert("p256", rsa_like, "p256", rsa_like)
    with pytest.raises(ecdsa.EcdsaError, match="not P-384|ecdsa-with-SHA384"):
        ecdsa.parse_certificate(p256.public_bytes(serialization.Encoding.DER))


def test_a_port_fake_quote_verifies_under_the_jax_verifier():
    backend = FakeGpuBackend(num_gpus=2, num_switches=1, initial_mode=MODE_ON)
    quote = backend.fetch_attestation("nonce-a")
    as_jax = JaxQuote(**dataclasses.asdict(quote))
    assert jax_attestation.verify_quote(as_jax, "nonce-a", MODE_ON, "fake-node-0",
                                        allow_fake=True) == []
    with pytest.raises(jax_attestation.AttestationError):
        jax_attestation.verify_quote(dataclasses.replace(as_jax, nonce="nonce-b"), "nonce-b",
                                     MODE_ON, allow_fake=True)
    # And the JAX fake's quote under the port's verifier.
    from tpu_cc_manager.tpudev.fake import FakeTpuBackend

    jax_quote = FakeTpuBackend(initial_mode=MODE_ON).fetch_attestation("nonce-c")
    assert attestation.verify_quote(AttestationQuote(**dataclasses.asdict(jax_quote)),
                                    "nonce-c", MODE_ON, allow_fake=True) == []


def test_serialize_and_digest_match_the_jax_functions(signer):
    fake = FakeGpuBackend().fetch_attestation("nonce-a")
    with_evidence = dataclasses.replace(h100_quote(signer),
                                        host_evidence={"gpu0": "x", "ünïcode": "é"})
    for quote in (fake, with_evidence):
        as_jax = JaxQuote(**dataclasses.asdict(quote))
        wire = attestation.serialize_quote(quote)
        assert wire == jax_attestation.serialize_quote(as_jax)
        assert attestation.quote_digest(quote) == jax_attestation.quote_digest(as_jax)
        assert attestation.deserialize_quote(wire) == quote
        assert jax_attestation.deserialize_quote(wire) == as_jax
    with pytest.raises(attestation.AttestationError, match="undeserializable"):
        attestation.deserialize_quote('{"slice_id": 1}')


def test_the_backend_quote_verifies_end_to_end(signer, tmp_path, monkeypatch):
    """H100Backend.fetch_attestation through the ctypes bindings on the
    injected NVML, CC on: every GPU's report over the nonce's challenge."""
    monkeypatch.setenv(attestation.ROOT_CERT_ENV, signer.write_root(tmp_path / "root.pem"))
    rig = Rig(tmp_path / "rig", mode=MODE_ON, signer=signer)
    rig.backend.discover()
    nonce = attestation.fresh_nonce()
    quote = rig.backend.fetch_attestation(nonce)
    assert quote.platform == "h100" and quote.mode == MODE_ON
    assert len(json.loads(quote.signature)) == len(GPU_BDFS)
    assert attestation.verify_quote(quote, nonce, MODE_ON, "h100-node-0") == []
    assert attestation.quote_problems(quote, "stale", MODE_ON)  # a replay fails
