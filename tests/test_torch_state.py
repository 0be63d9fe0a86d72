"""The port's conversions from the JAX package's state (delay_enc_tpu_torch
/state.py): limbs <-> words, an SRS from JAX G1 powers, a proving key from
JAX fields."""

import os

import numpy as np
import torch

from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu_torch import state
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.plonk import SRS

SRS_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench_data_cpu",
                        "srs_bn254_k11.npz")


def test_limbs_words_round_trip():
    rng = np.random.default_rng(1)
    limbs = rng.integers(0, 1 << 16, (5, 3, 16), dtype=np.uint32)
    words = state.from_jax_limbs(limbs, device="cpu")
    assert words.dtype == torch.int32 and words.shape == (5, 3, 8)
    assert np.array_equal(state.to_jax_limbs(words), limbs)
    # the same integers in both layouts
    assert JL.limbs_to_ints_np(limbs.reshape(-1, 16)) == [
        int.from_bytes(np.ascontiguousarray(r).tobytes(), "little")
        for r in words.numpy().view(np.uint32).reshape(-1, 8)]


def test_srs_from_jax_matches_load():
    z = np.load(SRS_FILE, allow_pickle=True)
    loaded = SRS.load(SRS_FILE, device="cpu")
    srs = state.srs_from_jax(z["g1"], loaded.tau_g2, device="cpu")
    assert srs.k == loaded.k == 11
    assert torch.equal(srs.g1_powers, loaded.g1_powers)
    assert TM.points_from_device(srs.g1_powers[:4]) == TM.points_from_device(loaded.g1_powers[:4])


def test_proving_key_from_jax_fields():
    rng = np.random.default_rng(2)
    arr = lambda *s: rng.integers(0, 1 << 16, (*s, 16), dtype=np.uint32)
    names = ("q_a", "tag_a")
    fields = {
        "k": 3, "fixed_commitments": {n: None for n in names},
        "sigma_commitments": [None] * 6, "transcript_repr": 7, "delta_powers": [1, 2],
        "fixed_raw": {n: arr(8) for n in names}, "fixed_coeff": {n: arr(8) for n in names},
        "fixed_ext": {n: arr(64) for n in names},
        "sigma_coeff": [arr(8)] * 6, "sigma_ext": [arr(64)] * 6,
        "l0_ext": arr(64), "l_last_ext": arr(64), "l_blind_ext": arr(64), "x_ext": arr(64),
        "zeta_powers": arr(64), "zeta_inv_powers": arr(64), "zh_inv_ext": arr(64),
    }
    pk = state.proving_key_from_jax(fields, device="cpu")
    assert pk.vk.domain.k == 3 and pk.vk.transcript_repr == 7
    assert np.array_equal(state.to_jax_limbs(pk.fixed_ext["tag_a"]), fields["fixed_ext"]["tag_a"])
    assert np.array_equal(state.to_jax_limbs(pk.zh_inv_ext), fields["zh_inv_ext"])
    assert pk.device.type == "cpu" and pk.delta_powers == [1, 2]
