"""Evaluation domain: the 2^k row domain H, the extended coset domain for
the quotient, and Lagrange helpers.

Counterpart of `delay_enc_tpu/plonk/domain.py`.  The NTT plans and the
matmul NTT's plans (`mxu_plan`) live on a device and are built on first use
for that device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops import ntt_mxu as NX
from ..ops.ntt import NTTPlan

# degree bound: gate 3, lookup 6, permutation 2 + NUM_ADVICE = 7
MAX_DEGREE = 8  # extended domain multiplier (next pow2 >= max constraint deg)
EXT_LOG = 3  # log2(MAX_DEGREE)
QUOTIENT_PIECES = 7
BLINDING_ROWS = 6
# From this k on, keygen picks the split quotient: MAX_DEGREE separate
# size-n cosets instead of one fused 8n domain (halo2's strategy), which
# keeps one coset's evaluations live at a time.
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

    def coset_shift(self, j: int) -> int:
        """Shift of the j-th size-n coset of the split quotient: the cosets
        zeta*g^j*H (g = omega_ext) together are the extended coset
        zeta*H_ext, with coset j's element i at extended index
        MAX_DEGREE*i + j."""
        return self.zeta * pow(self.omega_ext, j, FR.p) % FR.p

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

    MXU_KINDS = ("fwd", "inv", "ext", "ext_inv")

    def mxu_plan(self, kind: str, device) -> NX.MXUPlan:
        """The matmul NTT's plan on `device` (`create_proof(ntt="mxu")`):
        "fwd" and "inv" (1/n folded in) of length n; "ext", coefficients
        (zero-padded to n_ext) to evaluations on zeta*H_ext, zeta^j folded
        in; "ext_inv", back with 1/n_ext and zeta^-i folded in."""
        key = ("mxu", kind, str(device))
        if key not in self._plans:
            inv = FR.inv
            args = {
                "fwd": (self.k, self.omega, {}),
                "inv": (self.k, self.omega_inv, {"out_mul": inv(self.n)}),
                "ext": (self.k_ext, self.omega_ext, {"in_scale": self.zeta}),
                "ext_inv": (self.k_ext, inv(self.omega_ext),
                            {"out_mul": inv(self.n_ext), "out_scale": inv(self.zeta)}),
            }
            if kind not in args:
                raise ValueError(f"unknown MXU plan {kind!r}; expected one of {self.MXU_KINDS}")
            k, omega, folds = args[kind]
            self._plans[key] = NX.make_plan(L.FR_CTX, k, omega, device, **folds)
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
