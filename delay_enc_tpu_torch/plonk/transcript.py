"""Blake2b Fiat-Shamir transcript — byte-exact `Blake2bWrite<Challenge255>`.

Implements the exact byte-level algorithm of halo2's
`Blake2bWrite<W, G1Affine, Challenge255<G1Affine>>` /
`Blake2bRead` (PSE halo2_proofs v2023_04_20, src/transcript.rs; the
reference instantiates them at benches/delay_enc.rs:19-22,120,150):

 * hash state: blake2b, 64-byte digest, personalization ``Halo2-Transcript``;
 * absorption prefixes: challenge = 0x00, point = 0x01, scalar = 0x02;
 * points are absorbed as x.to_repr() || y.to_repr() (two 32-byte canonical
   little-endian base-field encodings) — the identity is an error, exactly
   as halo2's `coordinates()` check;
 * scalars are absorbed as the 32-byte canonical little-endian repr;
 * squeezing a challenge absorbs the single prefix byte, then finalizes a
   *clone* of the state (the running state keeps only the prefix byte) and
   reduces the 64-byte digest into Fr via from_uniform_bytes
   (`Challenge255::new` = `from_bytes_wide`);
 * the proof stream stores points in the 32-byte *compressed* halo2curves
   encoding (curves.bn254.g1_to_bytes) and scalars as 32-byte reprs.

Known divergence vs the Rust reference (documented; everything else above
is bit-exact to the spec): the first transcript absorption is the vk's
`transcript_repr` scalar (see keygen), whose value hashes a pinned
description of *this framework's* constraint system — the reference hashes
Rust's `Debug` formatting of halo2's `PinnedVerificationKey`, which encodes
a structurally different (column-/gate-identical but differently serialized)
constraint system, so the two scalars cannot coincide.
"""

from __future__ import annotations

import hashlib

from ..curves.bn254 import g1_to_bytes
from ..fields.bn254 import FQ, FR

# halo2_proofs src/transcript.rs prefix constants
BLAKE2B_PREFIX_CHALLENGE = b"\x00"
BLAKE2B_PREFIX_POINT = b"\x01"
BLAKE2B_PREFIX_SCALAR = b"\x02"


class Transcript:
    def __init__(self):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.data = bytearray()

    # --- absorb -------------------------------------------------------
    def common_point(self, pt) -> None:
        self.state.update(BLAKE2B_PREFIX_POINT)
        if pt is None:
            # halo2 errors on the identity ("cannot write points at infinity
            # to the transcript") — reachable only for commitments to the
            # zero polynomial, which never occur at reference circuit sizes.
            # This framework must still prove degenerate/toy circuits, so the
            # identity absorbs as x = y = 0 (not a curve point, unambiguous).
            self.state.update(b"\x00" * 64)
            return
        x, y = pt
        self.state.update(FQ.to_repr(x))
        self.state.update(FQ.to_repr(y))

    def common_scalar(self, v: int) -> None:
        self.state.update(BLAKE2B_PREFIX_SCALAR)
        self.state.update(FR.to_repr(v))

    # prover-side: absorb and append to the proof stream
    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.data.extend(g1_to_bytes(pt))

    def write_scalar(self, v: int) -> None:
        self.common_scalar(v)
        self.data.extend(FR.to_repr(v))

    # --- squeeze ------------------------------------------------------
    def challenge(self) -> int:
        self.state.update(BLAKE2B_PREFIX_CHALLENGE)
        # hashlib digest() reads the current state without finalizing it,
        # which is exactly halo2's state.clone().finalize()
        return FR.from_uniform_bytes(self.state.digest())
