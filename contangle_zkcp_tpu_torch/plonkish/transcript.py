"""halo2-exact Fiat-Shamir transcript (Blake2b, Challenge255 semantics).

Port of `contangle_zkcp_tpu/plonkish/transcript.py` (host code, copied as
is): the same absorbs give the same bytes and challenges.

Replaces the bootstrap SHA256 chain with the transcript halo2_proofs'
`Blake2bWrite`/`Blake2bRead` implement (transcript.rs), byte for byte at
the primitive level:

  * running `blake2b` state, 64-byte digest, personalization
    b"Halo2-Transcript";
  * domain-prefix bytes  0 = challenge squeeze, 1 = point, 2 = scalar;
  * `common_point` absorbs the affine x and y coordinate *reprs*
    (32-byte little-endian field encodings) — the proof stream carries
    compressed points, but the transcript state sees both coordinates;
  * `squeeze_challenge` updates with the challenge prefix, then
    finalizes a CLONE of the state; the 64-byte digest reduces into the
    scalar field little-endian (`Challenge255::get_scalar` /
    `from_uniform_bytes`).

The commitment curve is Vesta (base field PASTA_Q, scalar field
PASTA_P) exactly as halo2-with-IPA commits circuits over the Pallas
base field, so coordinate reprs are PASTA_Q-elements and challenges are
PASTA_P-elements.  Reference consumer of this stack:
circuits-halo2/src/encryption.rs:326-343 (MockProver —
the reference never serializes a real halo2 proof, so the transcript's
external anchor is the documented halo2 algorithm rather than captured
bytes; divergences of the surrounding PROOF SHAPE from halo2's are
documented in plonkish/prover.py).
"""

from __future__ import annotations

import hashlib

from ..fields import instances as fi

_PERSON = b"Halo2-Transcript"
_PREFIX_CHALLENGE = b"\x00"
_PREFIX_POINT = b"\x01"
_PREFIX_SCALAR = b"\x02"


class Blake2bTranscript:
    """Write/read-symmetric transcript over Vesta points and PASTA_P
    scalars.  The verifier re-absorbs the same objects in the same
    order, so one class serves both directions."""

    def __init__(self):
        self._state = hashlib.blake2b(digest_size=64, person=_PERSON)

    # ---- absorb -----------------------------------------------------
    def common_point(self, pt) -> None:
        """pt: affine (x, y) over the Vesta base field, or None.

        halo2 errors on the identity ("cannot be written to transcript");
        we absorb a fixed 64-zero-byte marker instead so degenerate
        commitments (zero polynomial) stay total — a documented
        divergence that cannot occur in halo2's own proofs either."""
        self._state.update(_PREFIX_POINT)
        if pt is None:
            self._state.update(b"\x00" * 64)
            return
        x, y = pt
        self._state.update(int(x).to_bytes(32, "little"))
        self._state.update(int(y).to_bytes(32, "little"))

    def common_scalar(self, s: int) -> None:
        self._state.update(_PREFIX_SCALAR)
        self._state.update((int(s) % fi.PASTA_P).to_bytes(32, "little"))

    # ---- squeeze ----------------------------------------------------
    def squeeze_challenge(self) -> int:
        """Challenge255: prefix, clone-finalize, 64-byte LE reduction."""
        self._state.update(_PREFIX_CHALLENGE)
        digest = self._state.copy().digest()
        return int.from_bytes(digest, "little") % fi.PASTA_P
