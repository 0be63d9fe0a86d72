"""KZG structured reference string and commitments.

Counterpart of `delay_enc_tpu/plonk/kzg.py`, base-4 MSM tables only.  The
SRS G1 powers are built on the device with the fixed-base batched scalar
multiplication (`ops/msm.py:fixed_base_batch_mul`, kernel K-d); `load`
reads the JAX package's npz files.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..curves.bn254 import G2, G1_GEN, G2_GEN
from ..fields.bn254 import FR, Fq2
from ..ops import limbs as L
from ..ops import msm as M
from ..utils.device import resolve, synchronize


class SRS:
    def __init__(self, k: int, g1_powers, tau_g2, g2):
        self.k = k
        self.n = 1 << k
        self.g1_powers = g1_powers  # (n, 3, 8) projective Montgomery, or None
        self.tau_g2 = tau_g2  # [tau] G2 (host)
        self.g2 = g2  # G2 generator
        # base-4 pair tables keyed by truncation k, shared across views
        self._pair_tables: dict = {}
        self._prepared: dict = {}  # verifier G2Prepared lines (lazy)

    @property
    def device(self) -> torch.device:
        return self.g1_powers.device

    def prepared_pair(self):
        """(G2Prepared(tau_g2), G2Prepared(g2)) for the verifier."""
        if "pair" not in self._prepared:
            from ..curves.pairing import G2Prepared

            self._prepared["pair"] = (G2Prepared(self.tau_g2), G2Prepared(self.g2))
        return self._prepared["pair"]

    def pair_tables(self) -> torch.Tensor:
        """(16, n/2, 3, 8) base-4 pair tables of these points, built once
        and reused by every commitment."""
        if self.k not in self._pair_tables:
            self._pair_tables[self.k] = M.pair_tables(self.g1_powers)
        return self._pair_tables[self.k]

    @staticmethod
    def setup(k: int, tau: int | None = None, device="cuda") -> "SRS":
        """Powers [tau^i] G1 for i < 2^k, built on `device`.  Without `tau`
        the secret comes from OS randomness and is discarded."""
        device = resolve(device)
        if tau is None:
            tau = (secrets.randbits(300) % (FR.p - 1)) + 1
        powers = []
        cur = 1
        for _ in range(1 << k):
            powers.append(cur)
            cur = cur * tau % FR.p
        table = M.base_table(G1_GEN, device)
        g1 = M.fixed_base_batch_mul(table, M.scalars_to_words(powers, device))
        synchronize(device)
        srs = SRS(k, g1, G2.mul(G2_GEN, tau), G2_GEN)
        del tau, powers
        return srs

    @staticmethod
    def load(path: str, device="cuda") -> "SRS":
        """Read an SRS file of the JAX package (npz: k, g1 (n, 3, 16) uint32
        limbs, tau_g2 as four decimal strings) onto `device`."""
        device = resolve(device)
        z = np.load(path, allow_pickle=True)
        k = int(z["k"])
        g1 = L.to_tensor(L.limbs_to_words_np(z["g1"]), device)
        t = [int(s) for s in z["tau_g2"]]
        return SRS(k, g1, (Fq2(t[0], t[1]), Fq2(t[2], t[3])), G2_GEN)

    @staticmethod
    def load_host_meta(path: str) -> "SRS":
        """Verifier-only view of an SRS file: k and tau_g2, no G1 points."""
        z = np.load(path, allow_pickle=True)
        t = [int(s) for s in z["tau_g2"]]
        return SRS(int(z["k"]), None, (Fq2(t[0], t[1]), Fq2(t[2], t[3])), G2_GEN)

    def truncated(self, k: int) -> "SRS":
        """A lower-degree view of the same SRS (shared tau and table cache)."""
        if k > self.k:
            raise ValueError(f"SRS too small: k={self.k} < {k}")
        s = SRS(k, self.g1_powers[: 1 << k], self.tau_g2, self.g2)
        s._pair_tables = self._pair_tables
        s._prepared = self._prepared
        return s


def commit(srs: SRS, coeff_words: torch.Tensor) -> torch.Tensor:
    """KZG commitment to a coefficient-form poly: (m, 8) canonical words
    (m <= n) -> (3, 8) projective Montgomery."""
    m = coeff_words.shape[0]
    return M.msm(srs.g1_powers[:m], coeff_words)
