"""RSACircuit (mod_pow): x^e mod n with a variable 5-bit exponent.

Mirror of the reference's standalone RSA circuit
(reference/benches/mod_pow.rs:36-120): assign a Var-exponent public
key, assign x, run modpow, and equality-constrain the result against the
natively computed big_pow_mod constant."""

from __future__ import annotations

from dataclasses import dataclass

from ..cs import Builder
from ..fields.prime import PrimeField
from ..gadgets.big_integer import big_pow_mod, decompose_big
from ..gadgets.rsa import LIMB_WIDTH, RSAChip, RSAPublicKey

BITS_LEN = 2048
EXP_LIMB_BITS = 5


@dataclass
class RSACircuit:
    n: int
    e: int
    x: int
    field: PrimeField
    bits_len: int = BITS_LEN
    exp_limb_bits: int = EXP_LIMB_BITS

    def build(self) -> Builder:
        b = Builder(self.field)
        rsa_chip = RSAChip(b, self.bits_len, self.exp_limb_bits)
        bigint_chip = rsa_chip.bigint_chip()
        num_limbs = self.bits_len // LIMB_WIDTH

        pk = RSAPublicKey.var(self.n, self.e, num_limbs, self.exp_limb_bits)
        pk_assigned = rsa_chip.assign_public_key(pk)
        x_assigned = bigint_chip.assign_integer(
            decompose_big(self.x, num_limbs, LIMB_WIDTH)
        )
        powed = rsa_chip.modpow_public_key(x_assigned, pk_assigned)
        expected = bigint_chip.assign_constant_fresh(big_pow_mod(self.x, self.e, self.n))
        bigint_chip.assert_equal_fresh(powed, expected)
        return b
