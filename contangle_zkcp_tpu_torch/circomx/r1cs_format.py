"""circom .r1cs binary format (read + write).

Port of `contangle_zkcp_tpu/circomx/r1cs_format.py`, byte for byte the
same files.  Replaces the r1cs parsing of the reference's patched
ark-circom fork (a path dependency outside its repository).  Format per
the public iden3 r1cs spec:

  magic "r1cs" | u32 version | u32 n_sections
  sections: u32 type | u64 size | payload
    type 1 header:  u32 field_bytes | prime (LE) | u32 nWires |
                    u32 nPubOut | u32 nPubIn | u32 nPrvIn | u64 nLabels |
                    u32 mConstraints
    type 2 constraints: per constraint, for each of A,B,C:
                    u32 nnz then nnz * (u32 wire_id | coeff LE)
    type 3 wire2label: u64 per wire

The reference's pipeline additionally relies on a "hacked" circom that
emits r1cs over the BLS12-381 scalar field (circom/Makefile:1-4); the
writer here is field-parametric, so both BN254 and BLS12-381 r1cs files
can be produced and consumed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..utils.errors import SerializationError

MAGIC = b"r1cs"


@dataclass
class R1csFile:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    constraints: list  # [(A, B, C)] with each an {wire_id: coeff} dict
    wire2label: list = field(default_factory=list)

    @property
    def n_public(self) -> int:
        """Public wires (outputs + public inputs), excluding wire 0."""
        return self.n_pub_out + self.n_pub_in

    def field_bytes(self) -> int:
        return ((self.prime.bit_length() + 63) // 64) * 8


def read_r1cs(data: bytes) -> R1csFile:
    """Parse an r1cs file.  A file cut short anywhere raises
    SerializationError: every section must hold the bytes its header
    declares."""
    if data[:4] != MAGIC:
        raise SerializationError("not an r1cs file")
    try:
        return _read_sections(data)
    except struct.error as e:
        raise SerializationError(f"truncated r1cs file: {e}") from None


def _read_sections(data: bytes) -> R1csFile:
    version, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        stype, ssize = struct.unpack_from("<IQ", data, off)
        off += 12
        if off + ssize > len(data):
            raise SerializationError(f"truncated r1cs section {stype}")
        sections[stype] = data[off : off + ssize]
        off += ssize
    if 1 not in sections:
        raise SerializationError("missing r1cs header section")
    h = sections[1]
    (fbytes,) = struct.unpack_from("<I", h, 0)
    prime = int.from_bytes(h[4 : 4 + fbytes], "little")
    nw, npo, npi, nprv = struct.unpack_from("<IIII", h, 4 + fbytes)
    (nlab,) = struct.unpack_from("<Q", h, 20 + fbytes)
    (mcon,) = struct.unpack_from("<I", h, 28 + fbytes)

    constraints = []
    if 2 in sections:
        c = sections[2]
        coff = 0
        for _ in range(mcon):
            lcs = []
            for _ in range(3):
                (nnz,) = struct.unpack_from("<I", c, coff)
                coff += 4
                terms = {}
                for _ in range(nnz):
                    (wid,) = struct.unpack_from("<I", c, coff)
                    coff += 4
                    coeff = int.from_bytes(c[coff : coff + fbytes], "little")
                    coff += fbytes
                    terms[wid] = coeff
                lcs.append(terms)
            constraints.append(tuple(lcs))

    wire2label = []
    if 3 in sections:
        w = sections[3]
        wire2label = list(struct.unpack(f"<{len(w)//8}Q", w))

    return R1csFile(
        prime=prime,
        n_wires=nw,
        n_pub_out=npo,
        n_pub_in=npi,
        n_prv_in=nprv,
        n_labels=nlab,
        constraints=constraints,
        wire2label=wire2label,
    )


def write_r1cs(f: R1csFile) -> bytes:
    fbytes = f.field_bytes()
    header = struct.pack("<I", fbytes)
    header += f.prime.to_bytes(fbytes, "little")
    header += struct.pack(
        "<IIIIQI", f.n_wires, f.n_pub_out, f.n_pub_in, f.n_prv_in, f.n_labels,
        len(f.constraints),
    )
    cons = b""
    for a, b, c in f.constraints:
        for terms in (a, b, c):
            cons += struct.pack("<I", len(terms))
            for wid, coeff in terms.items():
                cons += struct.pack("<I", wid) + int(coeff % f.prime).to_bytes(
                    fbytes, "little"
                )
    w2l = struct.pack(
        f"<{f.n_wires}Q", *(f.wire2label or list(range(f.n_wires)))
    )
    out = MAGIC + struct.pack("<II", 1, 3)
    for stype, payload in ((1, header), (2, cons), (3, w2l)):
        out += struct.pack("<IQ", stype, len(payload)) + payload
    return out
