"""Native Poseidon sponge encryption/decryption.

Faithful reimplementation of reference/src/encryption/poseidon_enc.rs
(MESSAGE_CAPACITY=2, CIPHER_SIZE=3 by default; parameterized here).

Behavioral notes preserved from the reference (bug-compatible on purpose —
the in-circuit twin asserts equality against these outputs, and the
reference's own tests only exercise zero messages):

 * encrypt (poseidon_enc.rs:86-133): ciphertext words are
   state[i+1] + message[i] computed on a *copy* of the state; when the final
   chunk is partial (len < RATE) the real state is permuted *without* the
   message added (the `squeeze(0)` branch at poseidon_enc.rs:123), so the tag
   is permute(state)[1] rather than permute(state + msg)[1].
 * decrypt (poseidon_enc.rs:135-164) adds the recovered message before the
   tag permutation, so encrypt->decrypt only round-trips for messages where
   the two paths agree (e.g. the all-zero messages used by the reference
   tests, poseidon_enc.rs:167-177).
"""

from __future__ import annotations

from ..poseidon.spec import Spec
from ..poseidon.sponge import Poseidon

MESSAGE_CAPACITY = 2  # poseidon_enc.rs:10 (max 31)
CIPHER_SIZE = MESSAGE_CAPACITY + 1


class PoseidonCipher:
    def __init__(self, spec: Spec, key: tuple[int, int], capacity: int = MESSAGE_CAPACITY):
        self.spec = spec
        self.key = key
        self.capacity = capacity
        self.cipher: list[int] = [0] * (capacity + 1)

    @property
    def cipher_size(self) -> int:
        return self.capacity + 1

    def initial_state(self, nonce: int) -> list[int]:
        """[0, 0, k0, k1, nonce] (poseidon_enc.rs:70-84)."""
        return [0, 0, self.key[0], self.key[1], nonce]

    def encrypt(self, message: list[int], nonce: int = 1) -> list[int]:
        spec = self.spec
        p = spec.field.p
        rate = spec.rate
        enc = Poseidon.new_enc(spec, self.key[0], self.key[1])
        cipher = [0] * self.cipher_size

        enc.update([])
        enc.squeeze(0)  # initial permutation (poseidon_enc.rs:99-100)

        i = 0
        for off in range(0, len(message), rate):
            chunk = message[off : off + rate]
            words = list(enc.state)  # copy, as in the reference
            for j, inp in enumerate(chunk):
                words[j + 1] = (words[j + 1] + inp) % p
                if i < self.capacity:
                    cipher[i] = words[j + 1]
                    i += 1
            if len(chunk) == rate:
                enc.update(chunk)
            else:
                enc.squeeze(0)

        cipher[self.capacity] = enc.state[1]
        self.cipher = cipher
        return cipher

    def decrypt(self, nonce: int = 1) -> list[int] | None:
        spec = self.spec
        p = spec.field.p
        t = spec.t
        enc = Poseidon.new_enc(spec, self.key[0], self.key[1])
        enc.update([])
        enc.squeeze(0)

        state_2 = list(enc.state)
        message = [0] * self.capacity
        for i in range(self.capacity):
            message[i] = (self.cipher[i] - state_2[(i + 1) % t]) % p
            state_2[(i + 1) % t] = self.cipher[i]

        enc.update(message)
        enc.squeeze(0)
        if self.cipher[self.capacity] != enc.state[1]:
            return None
        return message
