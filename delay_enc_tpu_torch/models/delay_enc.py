"""DelayEncryptCircuit: the full PVDE delay-encryption circuit.

Mirror of reference/src/lib.rs:101-318, composing three stages:

 1. "rsa modpow with 2048 bits" (lib.rs:179-206): assign (n, e, x), run the
    variable-exponent modpow, equality-constrain to the native big_pow_mod
    value;
 2. "hash mapping from 2048bit" (lib.rs:211-260): pack the 32 64-bit result
    limbs into 11 field elements (3 limbs each via base-2^64 mul_add
    ladders, final pair for limbs 30,31) and Poseidon-hash them; the key is
    h_out words 1 and 2;
 3. "poseidon region" (lib.rs:261-316): natively encrypt the message under
    the derived key, assign the expected ciphertext, run the in-circuit
    encryption with the key as witness (new_enc_de) equality-constrained to
    h_out, and constrain the ciphertext cells to the expected values.

No public inputs (lib.rs:352: `vec![vec![]]`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..cs import Builder, MainGate
from ..encryption.cipher import PoseidonCipher
from ..fields.prime import PrimeField
from ..gadgets.big_integer import big_pow_mod, decompose_big
from ..gadgets.enc_chip import MESSAGE_CAPACITY, PoseidonEncChip
from ..gadgets.hasher import HasherChip
from ..gadgets.rsa import LIMB_WIDTH, RSAChip, RSAPublicKey
from ..poseidon.spec import Spec

BITS_LEN = 2048  # lib.rs:122
EXP_LIMB_BITS = 5  # lib.rs:124


@dataclass
class DelayEncryptCircuit:
    n: int
    e: int
    x: int
    spec: Spec
    num_input: int
    message: list[int]
    bits_len: int = BITS_LEN
    exp_limb_bits: int = EXP_LIMB_BITS

    def build(self) -> Builder:
        field = self.spec.field
        b = Builder(field)
        mg = MainGate(b)
        rsa_chip = RSAChip(b, self.bits_len, self.exp_limb_bits)
        bigint_chip = rsa_chip.bigint_chip()
        num_limbs = self.bits_len // LIMB_WIDTH

        # --- region 1: rsa modpow (lib.rs:179-206) ---------------------
        pk = RSAPublicKey.var(self.n, self.e, num_limbs, self.exp_limb_bits)
        pk_assigned = rsa_chip.assign_public_key(pk)
        x_assigned = bigint_chip.assign_integer(
            decompose_big(self.x, num_limbs, LIMB_WIDTH)
        )
        powed = rsa_chip.modpow_public_key(x_assigned, pk_assigned)
        valid_powed = bigint_chip.assign_constant_fresh(
            big_pow_mod(self.x, self.e, self.n)
        )
        bigint_chip.assert_equal_fresh(powed, valid_powed)
        rsa_output = valid_powed  # the region returns the constant (lib.rs:204)

        # --- region 2: hash mapping (lib.rs:211-260) -------------------
        hasher = HasherChip(b, self.spec)
        base1 = mg.assign_constant(1 << LIMB_WIDTH)
        base2 = mg.mul(base1, base1)
        for i in range(rsa_output.num_limbs() // 3):
            a_poly = rsa_output.limb(3 * i)
            a_poly = mg.mul_add(rsa_output.limb(3 * i + 1), base1, a_poly)
            a_poly = mg.mul_add(rsa_output.limb(3 * i + 2), base2, a_poly)
            hasher.update([a_poly])
        a_poly = rsa_output.limb(30)
        a_poly = mg.mul_add(rsa_output.limb(31), base1, a_poly)
        hasher.update([a_poly])
        h_assigned = hasher.hash()
        h_out = [h_assigned[1], h_assigned[2]]

        # --- region 3: poseidon encryption (lib.rs:261-316) ------------
        pose_key = (h_out[0].value, h_out[1].value)
        ref_enc = PoseidonCipher(self.spec, pose_key, capacity=self.num_input)
        encryption_result = ref_enc.encrypt(self.message, 1)
        expected_cells = [mg.assign_value(v) for v in encryption_result]

        enc = PoseidonEncChip.new_de(b, self.spec, pose_key)
        mg.assert_equal(enc.pose_chip.state[2], h_out[0])
        mg.assert_equal(enc.pose_chip.state[3], h_out[1])
        enc.pose_chip.permutation([])
        for v in self.message[: self.num_input]:
            enc.pose_chip.set_inputs([mg.assign_value(v)])
        cipher_text = enc.absorb_and_relese(self.num_input)
        for ct, exp in zip(cipher_text, expected_cells):
            mg.assert_equal(ct, exp)
        return b
