"""KZG structured reference string and commitments.

Counterpart of `delay_enc_tpu/plonk/kzg.py`.  The SRS G1 powers are built
on the device with the fixed-base batched scalar multiplication
(`ops/msm.py:fixed_base_batch_mul`, one launch of the fused fixed-base
kernel); `save` and `load` write and read the JAX package's npz files, and
`setup(cache_dir=)` keeps one there.  The commitments' pair
tables, base 4 (`ops/msm.py`) or base 16 (`ops/msm16.py`), are built once
per SRS on first use and kept in memory; they are not cached on disk.
"""

from __future__ import annotations

import os
import secrets

import numpy as np
import torch

from ..curves.bn254 import G2, G1_GEN, G2_GEN
from ..fields.bn254 import FR, Fq2
from ..ops import limbs as L
from ..ops import msm as M
from ..ops import msm16 as M16
from ..utils.device import resolve, synchronize


class SRS:
    def __init__(self, k: int, g1_powers, tau_g2, g2):
        self.k = k
        self.n = 1 << k
        self.g1_powers = g1_powers  # (n, 3, 8) projective Montgomery, or None
        self.tau_g2 = tau_g2  # [tau] G2 (host)
        self.g2 = g2  # G2 generator
        # pair tables keyed by truncation k (base 4) or ("b16", k), shared
        # across views
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

    def pair_tables16(self) -> torch.Tensor:
        """(256, n/2, 3, 8) base-16 pair tables of these points: 16x the
        base-4 table's memory (805 MB at k=16), half its additions a
        commitment.  Built once and reused by every commitment."""
        key = ("b16", self.k)
        if key not in self._pair_tables:
            self._pair_tables[key] = M16.pair_tables16(self.g1_powers)
        return self._pair_tables[key]

    def msm_tables(self, msm: str = "b4") -> tuple:
        """("b4" | "b16", tables) for the commitment MSMs; the caller names
        the base (the JAX package reads DELAY_ENC_MSM)."""
        if msm == "b4":
            return "b4", self.pair_tables()
        if msm == "b16":
            return "b16", self.pair_tables16()
        raise ValueError(f"unknown MSM {msm!r}: 'b4' or 'b16'")

    @staticmethod
    def setup(k: int, tau: int | None = None, device="cuda", cache_dir: str | None = None) -> "SRS":
        """Powers [tau^i] G1 for i < 2^k, built on `device`.  Without `tau`
        the secret comes from OS randomness and is discarded.  With
        `cache_dir`, `srs_bn254_k{k}.npz` there is loaded if it exists (and
        `tau` ignored), else written after the setup: the JAX package's
        file and name, so either package reads the other's."""
        device = resolve(device)
        cache = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache = os.path.join(cache_dir, f"srs_bn254_k{k}.npz")
            if os.path.exists(cache):
                return SRS.load(cache, device)
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
        if cache:
            srs.save(cache)
        return srs

    def save(self, path: str) -> None:
        """npz of the JAX package: k, g1 (n, 3, 16) uint32 limbs and tau_g2
        as four decimal strings; compressed below k=21, where the points'
        near-random bytes make compression slow for little gain."""
        from .serialize import _atomic_savez

        tg = self.tau_g2
        _atomic_savez(path, compressed=self.k < 21, k=self.k,
                      g1=L.words_to_limbs_np(L.to_numpy(self.g1_powers)),
                      tau_g2=np.array([str(c) for c in (tg[0].c0, tg[0].c1, tg[1].c0, tg[1].c1)]))

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
