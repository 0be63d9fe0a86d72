"""Grain LFSR parameter generation for Poseidon (eprint 2019/458, appendix F).

Bit-exact reimplementation of the reference's constant derivation
(reference/src/poseidon/grain.rs:12-161): an 80-bit LFSR seeded with
the (field_type, sbox, field_size, T, r_f, r_p) header, 160 warm-up clocks,
then round constants via rejection sampling and Cauchy-matrix x/y vectors via
wide reduction (FromUniformBytes<64>).

Bit-ordering subtlety preserved from the reference (grain.rs:86-97): sampled
bits are interpreted MSB-first over the canonical little-endian byte repr.
"""

from __future__ import annotations

from ..fields.prime import PrimeField


class _Grain:
    def __init__(self, field: PrimeField, t: int, r_f: int, r_p: int):
        assert t > 1
        assert r_f % 2 == 0
        field_size = field.num_bits
        assert (field_size + 7) // 8 == field.num_bytes
        bits: list[int] = []

        def append(n, val):
            for i in reversed(range(n)):
                bits.append((val >> i) & 1)

        append(2, 1)  # FIELD_TYPE = prime field (grain.rs:16)
        append(4, 0)  # SBOX_TYPE = alpha sbox (grain.rs:18)
        append(12, field_size)
        append(12, t)
        append(10, r_f)
        append(10, r_p)
        append(30, (1 << 30) - 1)
        assert len(bits) == 80
        self.state = bits
        self.field = field
        for _ in range(160):
            self._new_bit()

    def _new_bit(self) -> int:
        s = self.state
        # taps at 0 ^ 13 ^ 23 ^ 38 ^ 51 ^ 62 (grain.rs:133-137)
        nb = s[0] ^ s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13]
        del s[0]
        s.append(nb)
        return nb

    def next_bit(self) -> int:
        """Self-shrinking output: emit a bit only after a 1 gate bit
        (grain.rs:148-153)."""
        while not self._new_bit():
            self._new_bit()
        return self._new_bit()

    def _sample_repr_int(self) -> tuple[int, bytes]:
        """Take NUM_BITS bits MSB-first into a little-endian byte repr
        (grain.rs:85-91); returns (int value, raw bytes)."""
        nbits = self.field.num_bits
        buf = bytearray(64)
        for i in range(nbits):
            bit = self.next_bit()
            j = nbits - 1 - i
            if bit:
                buf[j // 8] |= 1 << (j % 8)
        return int.from_bytes(buf, "little"), bytes(buf)

    def next_field_element(self) -> int:
        """Rejection-sampled canonical element (grain.rs:73-98)."""
        while True:
            v, _ = self._sample_repr_int()
            if v < self.field.p:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Wide reduction of the raw sampled bits (grain.rs:103-128)."""
        v, _ = self._sample_repr_int()
        return v % self.field.p


def grain_generate(field: PrimeField, t: int, r_f: int, r_p: int):
    """Returns (round_constants, mds) where round_constants is a list of
    (r_f + r_p) rows of T elements, and mds is the T x T Cauchy matrix
    inv(x_i + y_j) (grain.rs:49-68, spec.rs:170-180)."""
    g = _Grain(field, t, r_f, r_p)
    constants = [[g.next_field_element() for _ in range(t)] for _ in range(r_f + r_p)]
    xs = [g.next_field_element_without_rejection() for _ in range(t)]
    ys = [g.next_field_element_without_rejection() for _ in range(t)]
    mds = [[field.inv((x + y) % field.p) for y in ys] for x in xs]
    for row in mds:
        for e in row:
            assert e != 0
    return constants, mds
