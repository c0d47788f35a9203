"""ECDSA P-384 / SHA-384 verification and the X.509 fields it needs —
pure standard library.

The H100's attestation report is signed by a P-384 key whose certificate
chain leads to NVIDIA's device root (the JAX package's counterpart is the
RS256 check of ``tpudev/jwks.py``). Verification needs only point
arithmetic, so the agent's image carries no crypto dependency; the tests
make throwaway keys with the ``cryptography`` package. Only what the
attestation chain uses is accepted: ``ecdsa-with-SHA384`` signatures and
``id-ecPublicKey`` keys on ``secp384r1``; anything else fails closed.
"""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass


class EcdsaError(Exception):
    """A signature, key or certificate that does not verify or parse."""


# secp384r1 (SEC 2 v2 §2.5.1; FIPS 186-4 D.1.2.4): y^2 = x^3 - 3x + b mod p.
P = 2**384 - 2**128 - 2**96 + 2**32 - 1
A = P - 3
B = 0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973
G = (0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7,
     0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F)
COORD_BYTES = 48

OID_EC_PUBLIC_KEY = "1.2.840.10045.2.1"
OID_SECP384R1 = "1.3.132.0.34"
OID_ECDSA_SHA384 = "1.2.840.10045.4.3.3"


def on_curve(point: tuple[int, int]) -> bool:
    x, y = point
    return 0 <= x < P and 0 <= y < P and (y * y - (x * x * x + A * x + B)) % P == 0


# Jacobian coordinates (X, Y, Z) for x = X/Z^2, y = Y/Z^3; Z = 0 is infinity.
def _double(p1):
    x1, y1, z1 = p1
    if z1 == 0 or y1 == 0:
        return (0, 1, 0)
    yy = y1 * y1 % P
    s = 4 * x1 * yy % P
    zz = z1 * z1 % P
    m = 3 * (x1 - zz) * (x1 + zz) % P  # a = -3
    x3 = (m * m - 2 * s) % P
    return (x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * y1 * z1 % P)


def _add(p1, p2):
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    if u1 == u2:
        return _double(p1) if s1 == s2 else (0, 1, 0)
    h, r = (u2 - u1) % P, (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - s1 * hhh) % P, h * z1 * z2 % P)


def _affine(p1) -> tuple[int, int] | None:
    x, y, z = p1
    if z == 0:
        return None
    zinv = pow(z, -1, P)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 * zinv % P)


def _mul_add(u1: int, q1, u2: int, q2):
    """u1*q1 + u2*q2 (Shamir's trick) in Jacobian coordinates."""
    j1, j2 = (*q1, 1), (*q2, 1)
    both = _add(j1, j2)
    acc = (0, 1, 0)
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = _double(acc)
        b1, b2 = (u1 >> i) & 1, (u2 >> i) & 1
        if b1 and b2:
            acc = _add(acc, both)
        elif b1:
            acc = _add(acc, j1)
        elif b2:
            acc = _add(acc, j2)
    return acc


def verify(public_key: tuple[int, int], message: bytes, r: int, s: int) -> None:
    """ECDSA verification of (r, s) over SHA-384(``message``) on P-384.
    Raises EcdsaError unless it holds."""
    if not on_curve(public_key):
        raise EcdsaError("public key is not a point of P-384")
    if not (1 <= r < N and 1 <= s < N):
        raise EcdsaError("signature scalar out of range")
    e = int.from_bytes(hashlib.sha384(message).digest(), "big")
    w = pow(s, -1, N)
    point = _affine(_mul_add(e * w % N, G, r * w % N, public_key))
    if point is None or point[0] % N != r:
        raise EcdsaError("ECDSA P-384 signature does not verify")


def point_from_bytes(data: bytes) -> tuple[int, int]:
    """An uncompressed SEC 1 point (0x04 || X || Y)."""
    if len(data) != 1 + 2 * COORD_BYTES or data[0] != 4:
        raise EcdsaError("public key is not an uncompressed P-384 point")
    return (int.from_bytes(data[1:1 + COORD_BYTES], "big"),
            int.from_bytes(data[1 + COORD_BYTES:], "big"))


def raw_signature(data: bytes) -> tuple[int, int]:
    """(r, s) from a raw r || s signature of 2 x 48 bytes."""
    if len(data) != 2 * COORD_BYTES:
        raise EcdsaError(f"raw P-384 signature must be {2 * COORD_BYTES} bytes")
    return int.from_bytes(data[:COORD_BYTES], "big"), int.from_bytes(data[COORD_BYTES:], "big")


# ---- DER ----------------------------------------------------------------------

@dataclass(frozen=True)
class Tlv:
    tag: int
    value: bytes
    raw: bytes  # tag, length and value: what a signature over it covers


def read_tlv(data: bytes, offset: int = 0) -> tuple[Tlv, int]:
    """One DER element at ``offset`` and the offset after it."""
    try:
        tag = data[offset]
        length = data[offset + 1]
        start = offset + 2
        if length & 0x80:
            count = length & 0x7F
            if not 1 <= count <= 4:
                raise EcdsaError("unsupported DER length")
            length = int.from_bytes(data[start:start + count], "big")
            start += count
    except IndexError as e:
        raise EcdsaError("truncated DER") from e
    end = start + length
    if end > len(data):
        raise EcdsaError("truncated DER")
    return Tlv(tag, data[start:end], data[offset:end]), end


def children(tlv: Tlv) -> list[Tlv]:
    out, offset = [], 0
    while offset < len(tlv.value):
        child, offset = read_tlv(tlv.value, offset)
        out.append(child)
    return out


def oid(tlv: Tlv) -> str:
    if tlv.tag != 0x06 or not tlv.value:
        raise EcdsaError("expected an OBJECT IDENTIFIER")
    first = tlv.value[0]
    parts = [min(first // 40, 2), first - 40 * min(first // 40, 2)]
    n = 0
    for byte in tlv.value[1:]:
        n = (n << 7) | (byte & 0x7F)
        if not byte & 0x80:
            parts.append(n)
            n = 0
    return ".".join(map(str, parts))


def der_signature(data: bytes) -> tuple[int, int]:
    """(r, s) from an ECDSA-Sig-Value SEQUENCE { r INTEGER, s INTEGER }."""
    seq, end = read_tlv(data)
    if seq.tag != 0x30 or end != len(data):
        raise EcdsaError("ECDSA signature is not one DER SEQUENCE")
    parts = children(seq)
    if len(parts) != 2 or any(p.tag != 0x02 for p in parts):
        raise EcdsaError("ECDSA signature is not two INTEGERs")
    return tuple(int.from_bytes(p.value, "big") for p in parts)


@dataclass(frozen=True)
class Certificate:
    der: bytes
    tbs: bytes            # the signed TBSCertificate, as encoded
    issuer: bytes         # the issuer Name, as encoded
    subject: bytes
    public_key: tuple[int, int]
    signature: tuple[int, int]


def parse_certificate(der: bytes) -> Certificate:
    """The fields the chain check needs from one X.509 certificate."""
    cert, end = read_tlv(der)
    if cert.tag != 0x30 or end != len(der):
        raise EcdsaError("certificate is not one DER SEQUENCE")
    parts = children(cert)
    if len(parts) != 3 or parts[2].tag != 0x03:
        raise EcdsaError("certificate is not TBS, algorithm, signature")
    tbs, alg, sig = parts
    if oid(children(alg)[0]) != OID_ECDSA_SHA384:
        raise EcdsaError("certificate is not signed with ecdsa-with-SHA384")
    fields = children(tbs)
    if fields and fields[0].tag == 0xA0:  # [0] EXPLICIT version
        fields = fields[1:]
    if len(fields) < 6:
        raise EcdsaError("TBSCertificate is missing fields")
    _serial, _alg, issuer, _validity, subject, spki = fields[:6]
    key_alg, key_bits = children(spki)
    key_oids = [oid(t) for t in children(key_alg)]
    if key_oids != [OID_EC_PUBLIC_KEY, OID_SECP384R1]:
        raise EcdsaError(f"certificate key is not P-384 ({key_oids})")
    if key_bits.tag != 0x03 or not key_bits.value or key_bits.value[0] != 0:
        raise EcdsaError("malformed subjectPublicKey")
    if not sig.value or sig.value[0] != 0:
        raise EcdsaError("malformed signatureValue")
    return Certificate(der=der, tbs=tbs.raw, issuer=issuer.raw, subject=subject.raw,
                       public_key=point_from_bytes(key_bits.value[1:]),
                       signature=der_signature(sig.value[1:]))


def split_certificates(data: bytes) -> list[bytes]:
    """The DER certificates of a PEM bundle or of concatenated DER."""
    begin, end = b"-----BEGIN CERTIFICATE-----", b"-----END CERTIFICATE-----"
    if begin in data:
        out = []
        for block in data.split(begin)[1:]:
            if end not in block:
                raise EcdsaError("truncated PEM certificate")
            body = block.split(end)[0]
            try:
                out.append(base64.b64decode(b"".join(body.split()), validate=True))
            except ValueError as e:
                raise EcdsaError(f"PEM certificate is not base64: {e}") from e
        return out
    out, offset = [], 0
    while offset < len(data):
        tlv, offset = read_tlv(data, offset)
        out.append(tlv.raw)
    return out


def verify_signed_by(child: Certificate, parent: Certificate) -> None:
    if child.issuer != parent.subject:
        raise EcdsaError("certificate's issuer is not its parent's subject")
    verify(parent.public_key, child.tbs, *child.signature)


def verify_chain(chain: list[Certificate], root: Certificate) -> None:
    """Leaf first: each certificate signed by the next, the last by (or
    equal to) ``root``."""
    if not chain:
        raise EcdsaError("empty certificate chain")
    for child, parent in zip(chain, chain[1:]):
        verify_signed_by(child, parent)
    if chain[-1].der != root.der:
        verify_signed_by(chain[-1], root)
