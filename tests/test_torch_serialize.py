"""Key and SRS files of the port against the JAX package's, at k=7 on the CPU.

The port's keygen of the circuit of tests/test_torch_prover.py (SRS tau
123456789 at k=7, the key at the circuit's k=5) runs once a quotient mode,
through `runtime/workloads.get_keys`, which saves the key.  The JAX package only reads and writes files here: its
load_pk, save_pk, load_vk and SRS.load (no JAX keygen, no JAX proof).  A
key written by either package and read by the other must prove the golden
bytes of tests/data/torch_port_k7.npz, in both MSM bases and with a split
key.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

FUSED_EXT = ("l0_ext", "l_last_ext", "l_blind_ext", "x_ext", "zeta_powers", "zh_inv_ext")
SPLIT_COEFF = ("l0_coeff", "l_last_coeff", "l_blind_coeff")


@pytest.fixture(scope="module")
def golden_proof():
    with np.load(GOLDEN) as z:
        return z["proof"].tobytes(), str(z["transcript_repr"])


@pytest.fixture(scope="module")
def srs():
    from delay_enc_tpu_torch.plonk import SRS

    return SRS.setup(K, tau=TAU, device="cpu")


@pytest.fixture(scope="module")
def builder():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR

    return _build_circuit(cs, FR)


@pytest.fixture(scope="module", params=[False, True], ids=["fused", "split"])
def keys(request, srs, builder, tmp_path_factory):
    """The port's key, made and saved by get_keys: (pk, key_path).  Its k is
    the circuit's least (5), as the golden's keygen takes it."""
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime import workloads as W

    d = str(tmp_path_factory.mktemp("keys"))
    pk, vk, path = W.get_keys("k7", builder, srs, min_k(builder), d, split=request.param,
                              device="cpu")
    assert pk.vk is vk and pk.split is request.param
    return pk, path


def _jax_limbs(t):
    from delay_enc_tpu_torch import state

    return state.to_jax_limbs(t)


def test_port_pk_file_is_jax_key(keys):
    """Port save_pk -> JAX load_pk: every field of the JAX key equals the
    port's, zeta_inv_powers equal to the JAX keygen's own table."""
    import jax

    from delay_enc_tpu.plonk.domain import Domain as JDomain
    from delay_enc_tpu.plonk.keygen import _zeta_inv_powers
    from delay_enc_tpu.plonk.serialize import load_pk as jax_load_pk
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    pk, path = keys
    jpk = jax_load_pk(path)
    g = lambda a: np.asarray(jax.device_get(a))
    assert jpk.split is pk.split and jpk.delta_powers == pk.delta_powers
    assert jpk.vk.transcript_repr == pk.vk.transcript_repr
    assert jpk.vk.fixed_commitments == pk.vk.fixed_commitments
    assert jpk.vk.sigma_commitments == pk.vk.sigma_commitments
    for name in ALL_FIXED:
        assert np.array_equal(g(jpk.fixed_raw[name]), _jax_limbs(pk.fixed_raw[name])), name
        assert np.array_equal(g(jpk.fixed_coeff[name]), _jax_limbs(pk.fixed_coeff[name])), name
        if not pk.split:
            assert np.array_equal(g(jpk.fixed_ext[name]), _jax_limbs(pk.fixed_ext[name])), name
    for c in range(len(pk.sigma_coeff)):
        assert np.array_equal(g(jpk.sigma_coeff[c]), _jax_limbs(pk.sigma_coeff[c]))
        if not pk.split:
            assert np.array_equal(g(jpk.sigma_ext[c]), _jax_limbs(pk.sigma_ext[c]))
    for name in SPLIT_COEFF if pk.split else FUSED_EXT:
        assert np.array_equal(g(getattr(jpk, name)), _jax_limbs(getattr(pk, name))), name
    for name in FUSED_EXT if pk.split else SPLIT_COEFF:
        assert getattr(jpk, name) is None, name
    k = pk.vk.domain.k
    want = g(_zeta_inv_powers(JDomain(k)))
    assert want.shape == (8 << k, 16)
    assert np.array_equal(g(jpk.zeta_inv_powers), want)


def test_jax_pk_file_proves_golden(keys, srs, builder, golden_proof, tmp_path):
    """JAX load_pk of the port's file, then JAX save_pk -> port load_pk ->
    port create_proof: the golden bytes in both MSM bases (a split key's
    proof is the fused proof's)."""
    from delay_enc_tpu.plonk.serialize import load_pk as jax_load_pk
    from delay_enc_tpu.plonk.serialize import save_pk as jax_save_pk
    from delay_enc_tpu_torch.plonk import create_proof
    from delay_enc_tpu_torch.plonk.serialize import load_pk

    pk, path = keys
    jax_path = str(tmp_path / "jax_written")
    jax_save_pk(jax_load_pk(path), jax_path)
    got = load_pk(jax_path, device="cpu")
    assert got.split is pk.split and got.shape is None
    assert got.vk.transcript_repr == pk.vk.transcript_repr
    assert np.array_equal(_jax_limbs(got.quotient_unscale), _jax_limbs(pk.quotient_unscale))
    want = golden_proof[0]
    for msm in ("b4", "b16"):
        assert create_proof(srs, got, builder, np.random.default_rng(SEED), device="cpu",
                            msm=msm) == want, msm


def test_get_keys_finds_the_saved_key(keys, srs, builder):
    """A second get_keys loads the saved key (no keygen): the same vk, and
    the same words in every stack the prover reads."""
    import torch

    from delay_enc_tpu_torch.runtime import workloads as W
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    pk, path = keys
    with GLOBAL_METRICS.collect() as spans:
        got, vk, got_path = W.get_keys("k7", builder, srs, pk.vk.domain.k,
                                       os.path.dirname(path), device="cpu")
    assert got_path == path and "keys/load_pk" in spans and "keys/keygen" not in spans
    assert vk.transcript_repr == pk.vk.transcript_repr and got.split is pk.split
    for name in ("raw_stack", "ext_stack", "coeff_stack", "quotient_unscale", "x_ext",
                 "zeta_powers", "zh_inv_ext", "coset_powers", "coset_x", "coset_zh_inv"):
        want, have = getattr(pk, name), getattr(got, name)
        assert (want is None) == (have is None), name
        assert want is None or torch.equal(want, have), name
    for name in pk.fixed_coeff:
        assert torch.equal(pk.fixed_coeff[name], got.fixed_coeff[name]), name
    assert all(torch.equal(a, b) for a, b in zip(pk.sigma_coeff, got.sigma_coeff))
    assert got.delta_powers == pk.delta_powers


def test_loaded_key_holds_builders_to_its_circuit(keys, srs, builder):
    """A key the port saved comes back with the keyed circuit's shape, so
    the batched prover refuses a builder of another circuit, even alone
    (with no shape it would take that builder's own as the key's); a split
    key it refuses as such."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import create_proofs_batched
    from delay_enc_tpu_torch.plonk.keygen import circuit_shape
    from delay_enc_tpu_torch.plonk.serialize import load_pk

    pk, path = keys
    got = load_pk(path, device="cpu")
    assert got.shape == pk.shape == circuit_shape(builder)
    other = _build_circuit(cs, FR)
    cs.MainGate(other).assign_value(3)
    assert circuit_shape(other) != pk.shape
    with pytest.raises(ValueError, match="fused-quotient" if pk.split else "circuit shape"):
        create_proofs_batched(srs, got, [other], device="cpu")


def test_port_vk_file_is_jax_vk(keys, golden_proof, tmp_path):
    from delay_enc_tpu.plonk.serialize import load_vk as jax_load_vk
    from delay_enc_tpu_torch.plonk.keygen import load_vk as keygen_load_vk
    from delay_enc_tpu_torch.plonk.serialize import load_vk, save_vk

    pk, _ = keys
    path = str(tmp_path / "k7.vk.npz")
    save_vk(pk.vk, path)
    assert str(jax_load_vk(path).transcript_repr) == golden_proof[1]
    assert str(load_vk(path).transcript_repr) == golden_proof[1]
    assert str(keygen_load_vk(path).transcript_repr) == golden_proof[1]


def test_srs_file_is_jax_srs(srs, tmp_path):
    """Port SRS.save -> JAX SRS.load: the same points and [tau] G2; the port
    reads its own file back."""
    import jax

    from delay_enc_tpu.plonk.kzg import SRS as JSRS
    from delay_enc_tpu_torch.plonk import SRS

    path = str(tmp_path / f"srs_bn254_k{K}.npz")
    srs.save(path)
    j = JSRS.load(path)
    assert j.k == K
    assert np.array_equal(np.asarray(jax.device_get(j.g1_powers)), _jax_limbs(srs.g1_powers))
    assert [(c.c0, c.c1) for c in j.tau_g2] == [(c.c0, c.c1) for c in srs.tau_g2]
    back = SRS.load(path, device="cpu")
    assert back.k == K and back.tau_g2 == srs.tau_g2
    assert np.array_equal(_jax_limbs(back.g1_powers), _jax_limbs(srs.g1_powers))


def test_srs_setup_loads_its_cache(tmp_path):
    """SRS.setup(cache_dir=) writes srs_bn254_k{k}.npz, then reads it: the
    second call, without tau, gives the first one's points."""
    from delay_enc_tpu_torch.plonk import SRS

    d, k = str(tmp_path), 4
    first = SRS.setup(k, tau=TAU, device="cpu", cache_dir=d)
    path = os.path.join(d, f"srs_bn254_k{k}.npz")
    stamp = os.path.getmtime(path)
    second = SRS.setup(k, device="cpu", cache_dir=d)
    assert os.path.getmtime(path) == stamp
    assert second.k == k and second.tau_g2 == first.tau_g2
    assert np.array_equal(_jax_limbs(second.g1_powers), _jax_limbs(first.g1_powers))


def test_key_path_is_bench_name(tmp_path):
    """The key cache's name for bench.py's pose_enc k=11 statement is the
    committed one of bench_data_cpu/."""
    from delay_enc_tpu_torch.runtime import workloads as W

    path = W.key_path("pose_enc", W.build_circuit("pose_enc"), 11, str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    assert path.endswith("keys_pose_enc_03b0f1e6255bb975e1394ff696635139")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(os.path.join(root, "bench_data_cpu",
                                       os.path.basename(path) + ".vk.npz"))


def test_t_bits_are_bench_rows():
    import bench
    from delay_enc_tpu_torch.runtime import workloads as W

    assert W.T_BITS == bench.T_BITS


@pytest.mark.parametrize("workload,k", [("pose_enc", 11), ("delay_enc", 16)])
def test_draw_is_bench_circuit(workload, k):
    """runtime/workloads.build_circuit is bench.py's draw: the same rows,
    columns, copies and lookups for seed 42 (delay_enc k=16: the default
    5-bit window)."""
    import bench
    from delay_enc_tpu.utils.config import Config
    from delay_enc_tpu_torch.runtime import workloads as W

    want = bench.build_circuit(workload, Config(), seed=42, k=k)
    got = W.build_circuit(workload, k)
    assert got.rows == want.rows and list(got.fixed) == list(want.fixed)
    for g, w in zip([*got.advice, *got.fixed.values(), got.instance],
                    [*want.advice, *want.fixed.values(), want.instance]):
        assert [int(v) for v in g] == [int(v) for v in w]
    assert got.permutation_cycles() == want.permutation_cycles()
    assert got.lookup_widths == want.lookup_widths
