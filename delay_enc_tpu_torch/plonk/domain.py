"""Evaluation domain: the 2^k row domain H, the extended coset domain for
the quotient, and Lagrange helpers.

Counterpart of `delay_enc_tpu/plonk/domain.py`, without the MXU plans.  The
NTT plans live on a device and are built on first use for that device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.ntt import NTTPlan

# degree bound: gate 3, lookup 6, permutation 2 + NUM_ADVICE = 7
MAX_DEGREE = 8  # extended domain multiplier (next pow2 >= max constraint deg)
EXT_LOG = 3  # log2(MAX_DEGREE)
QUOTIENT_PIECES = 7
BLINDING_ROWS = 6
# From this k on the JAX package builds the quotient on separate size-n
# cosets; the port has only the fused 8n path and refuses such k.
SPLIT_QUOTIENT_K = 18


@dataclass
class Domain:
    k: int
    _plans: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def k_ext(self) -> int:
        return self.k + EXT_LOG

    @property
    def n_ext(self) -> int:
        return 1 << self.k_ext

    @property
    def usable_rows(self) -> int:
        """Rows available to the circuit: [0, usable); row `usable` is the
        l_last row, the final BLINDING_ROWS rows hold blinding values."""
        return self.n - BLINDING_ROWS - 1

    @cached_property
    def omega(self) -> int:
        return FR.root_of_unity(self.k)

    @cached_property
    def omega_inv(self) -> int:
        return FR.inv(self.omega)

    @cached_property
    def omega_ext(self) -> int:
        return FR.root_of_unity(self.k_ext)

    @cached_property
    def zeta(self) -> int:
        """Coset generator for the extended domain (the field generator)."""
        return FR.generator

    def plan(self, device) -> NTTPlan:
        """NTT plan of the row domain on `device`."""
        return self._plan(self.k, device)

    def plan_ext(self, device) -> NTTPlan:
        """NTT plan of the 8n extended domain on `device`."""
        return self._plan(self.k_ext, device)

    def _plan(self, k: int, device) -> NTTPlan:
        key = (k, str(device))
        if key not in self._plans:
            self._plans[key] = NTTPlan.make(L.FR_CTX, k, device)
        return self._plans[key]

    # ---- host-side Lagrange helpers (verifier) -----------------------
    def lagranges_at(self, idxs, x: int) -> dict:
        """{i: l_i(x)} for several indices with one field inversion."""
        idxs = list(idxs)
        p = FR.p
        xn1 = (pow(x, self.n, p) - 1) % p
        ws = [pow(self.omega, i, p) for i in idxs]
        dens = [self.n * (x - w) % p for w in ws]
        pre, acc = [], 1
        for d in dens:
            pre.append(acc)
            acc = acc * d % p
        inv = pow(acc, -1, p)
        out = {}
        for j in range(len(dens) - 1, -1, -1):
            di = inv * pre[j] % p
            inv = inv * dens[j] % p
            out[idxs[j]] = ws[j] * xn1 % p * di % p
        return out

    def vanishing_at(self, x: int) -> int:
        return (pow(x, self.n, FR.p) - 1) % FR.p
