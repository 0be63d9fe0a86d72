"""RSAChip: RSA operations over BigIntChip.

Capability port of reference/src/rsa/ (chip.rs, mod.rs,
instructions.rs): modpow with a fixed (e.g. 65537) or variable 5-bit-limb
exponent (the delay primitive), and PKCS#1 v1.5 signature verification with
the hard-coded SHA-256 DigestInfo prefix constants (chip.rs:131-202).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..cs import Builder, Cell
from .big_integer import AssignedInteger, BigIntChip, decompose_big

LIMB_WIDTH = 64  # rsa/chip.rs:206


@dataclass
class RSAPublicKey:
    """n limbs + exponent: ('var', e_limbs) or ('fix', e_int)
    (rsa/mod.rs:22-67)."""

    n_limbs: list[int]
    e: tuple  # ("var", list[int]) | ("fix", int)

    @staticmethod
    def var(n: int, e: int, num_limbs: int, exp_limb_bits: int) -> "RSAPublicKey":
        return RSAPublicKey(
            decompose_big(n, num_limbs, LIMB_WIDTH), ("var", decompose_big(e, 1, exp_limb_bits))
        )

    @staticmethod
    def fix(n: int, e: int, num_limbs: int) -> "RSAPublicKey":
        return RSAPublicKey(decompose_big(n, num_limbs, LIMB_WIDTH), ("fix", e))


@dataclass
class AssignedRSAPublicKey:
    n: AssignedInteger
    e: tuple  # ("var", AssignedInteger) | ("fix", int)


@dataclass
class RSASignature:
    c_limbs: list[int]

    @staticmethod
    def from_int(c: int, num_limbs: int) -> "RSASignature":
        return RSASignature(decompose_big(c, num_limbs, LIMB_WIDTH))


@dataclass
class AssignedRSASignature:
    c: AssignedInteger


class RSAChip:
    def __init__(self, builder: Builder, bits_len: int, exp_limb_bits: int):
        self.b = builder
        self.bits_len = bits_len
        self.exp_limb_bits = exp_limb_bits

    def bigint_chip(self) -> BigIntChip:
        return BigIntChip(self.b, LIMB_WIDTH, self.bits_len)

    def main_gate(self):
        return self.bigint_chip().mg

    @classmethod
    def compute_range_lens(cls, num_limbs: int):
        """rsa/chip.rs:252-257."""
        comp, over = BigIntChip.compute_range_lens(LIMB_WIDTH, num_limbs)
        comp.append(32 // 8)
        return comp, over

    # ------------------------------------------------------------------
    def assign_public_key(self, pk: RSAPublicKey) -> AssignedRSAPublicKey:
        bic = self.bigint_chip()
        n = bic.assign_integer(pk.n_limbs)
        if pk.e[0] == "var":
            # exponent limbs are range-checked to exp_limb_bits
            cells = [
                bic.rc.assign(v, BigIntChip.sublimb_bit_len(self.exp_limb_bits), self.exp_limb_bits)
                for v in pk.e[1]
            ]
            e = ("var", AssignedInteger(cells, "fresh"))
        else:
            e = ("fix", pk.e[1])
        return AssignedRSAPublicKey(n, e)

    def assign_signature(self, sig: RSASignature) -> AssignedRSASignature:
        return AssignedRSASignature(self.bigint_chip().assign_integer(sig.c_limbs))

    def modpow_public_key(
        self, x: AssignedInteger, public_key: AssignedRSAPublicKey
    ) -> AssignedInteger:
        """rsa/chip.rs:102-117: asserts x < n then pow_mod."""
        bic = self.bigint_chip()
        bic.assert_in_field(x, public_key.n)
        if public_key.e[0] == "var":
            return bic.pow_mod(x, public_key.e[1], public_key.n, self.exp_limb_bits)
        return bic.pow_mod_fixed_exp(x, public_key.e[1], public_key.n)

    def verify_pkcs1v15_signature(
        self,
        public_key: AssignedRSAPublicKey,
        hashed_msg: AssignedInteger,
        signature: AssignedRSASignature,
    ) -> Cell:
        """rsa/chip.rs:131-202 with the same hard-coded DigestInfo prefix /
        PS / EM constants."""
        bic = self.bigint_chip()
        mg = bic.mg
        is_eq = mg.assign_constant(1)
        powed = self.modpow_public_key(signature.c, public_key)
        hash_len = 4
        # 1. hashed data: first 4 limbs (256 bits)
        for i in range(hash_len):
            flag = mg.is_equal(powed.limb(i), hashed_msg.limb(i))
            is_eq = mg.and_(is_eq, flag)
        # 2. DigestInfo prefix + 0x00 byte
        prefix_64_1 = mg.assign_constant(217300885422736416)
        prefix_64_2 = mg.assign_constant(938447882527703397)
        is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(hash_len), prefix_64_1))
        is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(hash_len + 1), prefix_64_2))
        # remaining 24+ bits: split limb hash_len+2 into 32-bit halves
        v = powed.limb(hash_len + 2).value
        low_v, high_v = v & 0xFFFFFFFF, v >> 32
        remain_low = bic.rc.assign(low_v, 4, 32)
        remain_high = bic.rc.assign(high_v, 4, 32)
        u32_assign = mg.assign_constant(1 << 32)
        remain_concat = mg.mul_add(remain_high, u32_assign, remain_low)
        mg.assert_equal(powed.limb(hash_len + 2), remain_concat)
        prefix_32 = mg.assign_constant(3158320)
        is_eq = mg.and_(is_eq, mg.is_equal(remain_low, prefix_32))
        # 3. PS 0xff padding + EM header
        ff_32 = mg.assign_constant(4294967295)
        is_eq = mg.and_(is_eq, mg.is_equal(remain_high, ff_32))
        ff_64 = mg.assign_constant(18446744073709551615)
        for i in range(hash_len + 3, self.bits_len // LIMB_WIDTH - 1):
            is_eq = mg.and_(is_eq, mg.is_equal(powed.limb(i), ff_64))
        last_em = mg.assign_constant(562949953421311)
        is_eq = mg.and_(
            is_eq, mg.is_equal(powed.limb(self.bits_len // LIMB_WIDTH - 1), last_em)
        )
        return is_eq


class RSASignatureVerifier:
    """rsa/mod.rs:150-287: packs hashed-message bytes into 64-bit limbs and
    delegates to RSAChip::verify_pkcs1v15_signature (the in-circuit SHA256
    stage is absent in the reference — commented out pending a SHA chip,
    mod.rs:140-143 — so the hash bytes enter as witness, same here)."""

    def __init__(self, rsa_chip: RSAChip):
        self.rsa_chip = rsa_chip

    def verify_pkcs1v15_signature(
        self,
        public_key: AssignedRSAPublicKey,
        msg_hash_bytes: bytes,
        signature: AssignedRSASignature,
    ):
        mg = self.rsa_chip.main_gate()
        byte_cells = [mg.assign_value(b) for b in msg_hash_bytes]
        rev = list(reversed(byte_cells))
        limb_bytes = LIMB_WIDTH // 8
        assigned_limbs = []
        for i in range(len(rev) // limb_bytes):
            limb_val = mg.assign_constant(0)
            for j in range(limb_bytes):
                coeff = mg.assign_constant(1 << (8 * j))
                limb_val = mg.mul_add(coeff, rev[limb_bytes * i + j], limb_val)
            assigned_limbs.append(limb_val)
        hashed_msg = AssignedInteger(assigned_limbs, "fresh")
        is_valid = self.rsa_chip.verify_pkcs1v15_signature(
            public_key, hashed_msg, signature
        )
        return is_valid, byte_cells
