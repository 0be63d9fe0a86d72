"""Host-side prime-field parameter objects.

Field *elements* on the host are plain Python ints in [0, p); arithmetic is
done with int ops mod p (Python ints are GMP-class bignums, fast enough for
transcripts, constants generation and witness math).  The device
representation (base-2^16 limb tensors in Montgomery form) lives in
``delay_enc_tpu_torch.ops.limbs``.

Mirrors the role of `halo2curves` field types in the reference
(reference/Cargo.toml:14-17); the API is deliberately minimal.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PrimeField:
    name: str
    p: int
    # multiplicative generator of the full group (halo2curves `GENERATOR`)
    generator: int = 0
    # 2-adicity: p - 1 = 2^s * t with t odd
    s: int = field(init=False, default=0)

    def __post_init__(self):
        t, s = self.p - 1, 0
        while t % 2 == 0:
            t //= 2
            s += 1
        object.__setattr__(self, "s", s)

    # -- basic ops (elements are ints in [0, p)) --
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks; returns a square root or None."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if p % 4 == 3:
            # candidate-then-verify: one modexp instead of a Legendre
            # pre-check plus the root exponentiation
            r = pow(a, (p + 1) // 4, p)
            return r if r * r % p == a else None
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    @property
    def num_bits(self) -> int:
        return self.p.bit_length()

    @property
    def num_bytes(self) -> int:
        return (self.num_bits + 7) // 8

    def root_of_unity(self, k: int) -> int:
        """Primitive 2^k-th root of unity (requires k <= self.s)."""
        assert k <= self.s, f"field {self.name} has 2-adicity {self.s} < {k}"
        # generator^((p-1)/2^k)
        return pow(self.generator, (self.p - 1) >> k, self.p)

    # -- encodings --
    def to_repr(self, a: int) -> bytes:
        """Little-endian canonical byte repr (ff::PrimeField::Repr analog)."""
        return int(a % self.p).to_bytes(self.num_bytes, "little")

    def from_repr(self, b: bytes) -> int | None:
        """Parse canonical little-endian bytes; None if >= p
        (ff::from_repr_vartime analog, grain.rs:94)."""
        v = int.from_bytes(b, "little")
        return v if v < self.p else None

    def from_uniform_bytes(self, b: bytes) -> int:
        """Reduce a 64-byte little-endian integer mod p
        (ff::FromUniformBytes::<64> analog, grain.rs:127)."""
        assert len(b) == 64
        return int.from_bytes(b, "little") % self.p

    def random(self, rng) -> int:
        return self.from_uniform_bytes(bytes(rng.integers(0, 256, 64, dtype="uint8")))

    def hash_to_field(self, tag: bytes) -> int:
        """Deterministic domain-separated element (test helper)."""
        return self.from_uniform_bytes(hashlib.blake2b(tag, digest_size=64).digest())
