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


def test_proving_key_from_jax_stacks_are_its_columns():
    """A full key's stacks, in KEY_ROWS order, hold every named column, and
    the named columns are views of their rows."""
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

    rng = np.random.default_rng(3)
    arr = lambda *s: rng.integers(0, 1 << 16, (*s, 16), dtype=np.uint32)
    names = list(ALL_FIXED)[::-1]  # the dicts' order does not matter
    fields = {
        "k": 3, "fixed_commitments": {n: None for n in names},
        "sigma_commitments": [None] * 6, "transcript_repr": 7, "delta_powers": [1, 2],
        "fixed_raw": {n: arr(8) for n in names}, "fixed_coeff": {n: arr(8) for n in names},
        "fixed_ext": {n: arr(64) for n in names},
        "sigma_coeff": [arr(8) for _ in range(6)], "sigma_ext": [arr(64) for _ in range(6)],
        "l0_ext": arr(64), "l_last_ext": arr(64), "l_blind_ext": arr(64), "x_ext": arr(64),
        "zeta_powers": arr(64), "zeta_inv_powers": arr(64), "zh_inv_ext": arr(64),
    }
    pk = state.proving_key_from_jax(fields, device="cpu")
    assert pk.raw_stack.shape == (len(ALL_FIXED), 8, 8)
    assert pk.ext_stack.shape == (len(KEY_ROWS), 64, 8)
    want_ext = ([fields["fixed_ext"][n] for n in ALL_FIXED] + fields["sigma_ext"]
                + [fields["l0_ext"], fields["l_last_ext"], fields["l_blind_ext"]])
    for row, want in enumerate(want_ext):
        assert np.array_equal(state.to_jax_limbs(pk.ext_stack[row]), want), KEY_ROWS[row]
    for row, name in enumerate(ALL_FIXED):
        assert np.array_equal(state.to_jax_limbs(pk.raw_stack[row]), fields["fixed_raw"][name])
        assert pk.fixed_raw[name].data_ptr() == pk.raw_stack[row].data_ptr()
        assert pk.fixed_ext[name].data_ptr() == pk.ext_stack[row].data_ptr()
    nf = len(ALL_FIXED)
    views = pk.sigma_ext + [pk.l0_ext, pk.l_last_ext, pk.l_blind_ext]
    assert [v.data_ptr() for v in views] == [pk.ext_stack[nf + i].data_ptr() for i in range(9)]


def test_keygen_stacks_are_its_columns():
    """The port's own keygen: the same relation between stacks and views."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import keygen
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

    b = cs.Builder(FR)
    mg = cs.MainGate(b)
    mg.mul(mg.assign_value(3), mg.assign_value(5))
    srs = SRS.setup(4, tau=99, device="cpu")
    pk, _ = keygen(b, srs, k=4, device="cpu")
    assert pk.ext_stack.shape == (len(KEY_ROWS), 8 << 4, 8)
    views = ([pk.fixed_ext[n] for n in ALL_FIXED] + pk.sigma_ext
             + [pk.l0_ext, pk.l_last_ext, pk.l_blind_ext])
    for row, v in enumerate(views):
        assert torch.equal(v, pk.ext_stack[row]), KEY_ROWS[row]
    for row, name in enumerate(ALL_FIXED):
        assert torch.equal(pk.fixed_raw[name], pk.raw_stack[row])


def test_proving_key_from_jax_split_fields():
    """A JAX split-mode key's fields: coefficient rows and no extended-coset
    arrays.  The coefficient stack holds them in KEY_ROWS order, the named
    columns are views of its rows, and the coset tables are keygen's."""
    from delay_enc_tpu_torch.plonk.domain import Domain
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS, coset_tables

    rng = np.random.default_rng(4)
    arr = lambda *s: rng.integers(0, 1 << 16, (*s, 16), dtype=np.uint32)
    fields = {
        "k": 3, "split": True, "fixed_commitments": {n: None for n in ALL_FIXED},
        "sigma_commitments": [None] * 6, "transcript_repr": 7, "delta_powers": [1, 2],
        "fixed_raw": {n: arr(8) for n in ALL_FIXED}, "fixed_coeff": {n: arr(8) for n in ALL_FIXED},
        "fixed_ext": None, "sigma_coeff": [arr(8) for _ in range(6)], "sigma_ext": None,
        "l0_ext": None, "l_last_ext": None, "l_blind_ext": None, "x_ext": None,
        "zeta_powers": None, "zh_inv_ext": None, "zeta_inv_powers": arr(64),
        "l0_coeff": arr(8), "l_last_coeff": arr(8), "l_blind_coeff": arr(8),
    }
    pk = state.proving_key_from_jax(fields, device="cpu")
    assert pk.split and pk.ext_stack is None and pk.fixed_ext is None and pk.sigma_ext is None
    assert pk.x_ext is None and pk.zeta_powers is None and pk.zh_inv_ext is None
    assert pk.l0_ext is None and pk.device.type == "cpu"
    want = ([fields["fixed_coeff"][n] for n in ALL_FIXED] + fields["sigma_coeff"]
            + [fields["l0_coeff"], fields["l_last_coeff"], fields["l_blind_coeff"]])
    assert pk.coeff_stack.shape == (len(KEY_ROWS), 8, 8)
    for row, w in enumerate(want):
        assert np.array_equal(state.to_jax_limbs(pk.coeff_stack[row]), w), KEY_ROWS[row]
    nf = len(ALL_FIXED)
    views = ([pk.fixed_coeff[n] for n in ALL_FIXED] + pk.sigma_coeff
             + [pk.l0_coeff, pk.l_last_coeff, pk.l_blind_coeff])
    assert [v.data_ptr() for v in views] == [pk.coeff_stack[i].data_ptr() for i in range(nf + 9)]
    for got, want in zip((pk.coset_powers, pk.coset_x, pk.coset_zh_inv),
                         coset_tables(Domain(3), "cpu")):
        assert torch.equal(got, want)
    assert pk.quotient_unscale.shape == (64, 8)
