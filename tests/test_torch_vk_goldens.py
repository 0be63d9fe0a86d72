"""The JAX package's verifying keys at the sizes the card proves, so that
chip_smoke.py phases 4, 5 and 6 hold the port's keygen there to the JAX
package's bytes in both MSM bases.

Each file `tests/data/torch_port_vk_<workload>_k<k>.npz` is the JAX
package's keygen of bench.py's circuit for (workload, k) (seed 42, the
utils/config.py defaults, T_BITS of the row) on `SRS.setup(k, tau=TAU)`,
the tau of the chip_smoke phase that proves the row.  It holds the vk's
commitments as affine coordinates (x and y, 32 little-endian bytes each;
the point at infinity as zeros), its transcript_repr and the circuit's
shape, never a column.  The JAX keygen takes one to three and a half
hours on an 8-core CPU (delay_enc k=18 up to 41 GB of memory), so the
files are committed and the writers are `slow` tests; rewrite one file
with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_vk_goldens.py delay_enc 16
"""

import os
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # bench.py and chip_smoke.py live there

import chip_smoke  # noqa: E402  (the goldens' encoding and the card's check)

DATA = os.path.join(ROOT, "tests", "data")
SEED = 42
# (workload, k) -> SRS tau: chip_smoke phase 4, 5 and 6's SRS.setup
ROWS = {
    ("delay_enc", 16): 0x5EED_0F_DE1A7,
    ("mod_pow", 17): 0x5EED_0F_0D90,
    ("delay_enc", 18): 0x5EED_0F_DE1A7_18,
}
COMMITTED = sorted(row for row in ROWS
                   if os.path.exists(os.path.join(DATA, f"torch_port_vk_{row[0]}_k{row[1]}.npz")))


def golden_path(workload: str, k: int) -> str:
    return os.path.join(DATA, f"torch_port_vk_{workload}_k{k}.npz")


def points(arr: np.ndarray) -> list:
    """The affine points of `chip_smoke.vk_affine`'s encoding."""
    return [None if not row.any() else
            tuple(int.from_bytes(row[j].tobytes(), "little") for j in range(2))
            for row in arr]


def jax_golden(workload: str, k: int) -> dict:
    """The JAX package's keygen of bench.py's (workload, k) circuit."""
    import bench
    from delay_enc_tpu.plonk import SRS, keygen
    from delay_enc_tpu.plonk.keygen import ALL_FIXED, min_k
    from delay_enc_tpu.utils.config import Config

    import delay_enc_tpu.plonk.kernels as JK

    def per_column(tables, stack):
        # the JAX package's MSM one column at a time: the same commitments,
        # one column's selectors and bit planes in memory at once
        return [c for i in range(stack.shape[0]) for c in batch_commit(tables, stack[i:i + 1])]

    t0 = time.time()
    b = bench.build_circuit(workload, Config(), seed=SEED, k=k)
    srs = SRS.setup(k, tau=ROWS[(workload, k)])
    print(f"{workload} k={k}: circuit and SRS.setup {time.time() - t0:.1f} s", flush=True)
    batch_commit = JK.msm_commit_batch
    # the split key skips the extended-coset tables; the vk is the same in
    # both quotient modes
    with mock.patch.object(JK, "msm_commit_batch", per_column):
        _, vk = keygen(b, srs, k=k, split=True)
    print(f"{workload} k={k}: keygen {time.time() - t0:.1f} s in all", flush=True)
    return {
        "workload": np.array(workload), "k": np.array(k), "seed": np.array(SEED),
        "tau": np.array(hex(ROWS[(workload, k)])),
        "t_bits": np.array(bench.T_BITS[(workload, k)]),
        "rows": np.array(b.rows), "min_k": np.array(min_k(b)),
        "fixed_names": np.array(ALL_FIXED),
        "fixed": chip_smoke.vk_affine([vk.fixed_commitments[n] for n in ALL_FIXED]),
        "sigma": chip_smoke.vk_affine(vk.sigma_commitments),
        "transcript_repr": np.array(str(vk.transcript_repr)),
    }


def load(workload: str, k: int) -> dict:
    with np.load(golden_path(workload, k)) as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("row", COMMITTED, ids=[f"{w}-k{k}" for w, k in COMMITTED])
def test_golden_fields(row):
    """The file's fields and shapes, its row's draw, and commitments that
    are points of G1."""
    from delay_enc_tpu_torch.curves.bn254 import G1
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, NUM_PERM_COLS
    from delay_enc_tpu_torch.runtime.workloads import T_BITS

    workload, k = row
    z = load(workload, k)
    assert set(z) == {"workload", "k", "seed", "tau", "t_bits", "rows", "min_k", "fixed_names",
                      "fixed", "sigma", "transcript_repr"}
    assert (str(z["workload"]), int(z["k"]), int(z["seed"])) == (workload, k, SEED)
    assert int(str(z["tau"]), 16) == ROWS[row]
    assert int(z["t_bits"]) == T_BITS[row]
    assert int(z["min_k"]) <= k and int(z["rows"]) <= (1 << k) - 7
    assert list(z["fixed_names"]) == list(ALL_FIXED)
    assert z["fixed"].shape == (len(ALL_FIXED), 2, 32) and z["fixed"].dtype == np.uint8
    assert z["sigma"].shape == (NUM_PERM_COLS, 2, 32) and z["sigma"].dtype == np.uint8
    for p in points(z["fixed"]) + points(z["sigma"]):
        assert p is None or G1.is_on_curve(p)
    assert os.path.getsize(golden_path(workload, k)) < 8192


@pytest.mark.parametrize("row", COMMITTED, ids=[f"{w}-k{k}" for w, k in COMMITTED])
def test_golden_repr_is_its_commitments(row):
    """The port's transcript_repr of the file's commitments is the file's
    transcript_repr, and a changed commitment changes it."""
    from delay_enc_tpu_torch.plonk.domain import Domain
    from delay_enc_tpu_torch.plonk.keygen import transcript_repr

    z = load(*row)
    fixed = dict(zip(z["fixed_names"].tolist(), points(z["fixed"])))
    sigma = points(z["sigma"])
    domain = Domain(int(z["k"]))
    assert transcript_repr(domain, fixed, sigma) == int(str(z["transcript_repr"]))
    assert transcript_repr(domain, fixed, sigma[::-1]) != int(str(z["transcript_repr"]))


@pytest.mark.parametrize("row", COMMITTED, ids=[f"{w}-k{k}" for w, k in COMMITTED])
def test_port_circuit_shape_is_the_golden(row):
    """The port's build of the row (what chip_smoke keys on the card) has
    the golden's rows and min_k."""
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime.workloads import build_circuit

    workload, k = row
    z = load(workload, k)
    b = build_circuit(workload, k)
    assert (b.rows, min_k(b)) == (int(z["rows"]), int(z["min_k"]))


@pytest.mark.parametrize("row", COMMITTED, ids=[f"{w}-k{k}" for w, k in COMMITTED])
def test_chip_smoke_vk_parity(row, capsys):
    """chip_smoke's check on the card, given a vk with the golden's own
    commitments, prints equal=true; a vk with two commitments swapped, or
    another transcript_repr, prints equal=false and raises."""
    from delay_enc_tpu_torch.plonk.domain import Domain
    from delay_enc_tpu_torch.plonk.keygen import VerifyingKey

    workload, k = row
    z = load(workload, k)
    fixed = dict(zip(z["fixed_names"].tolist(), points(z["fixed"])))
    sigma = points(z["sigma"])
    circuit = SimpleNamespace(rows=int(z["rows"]))
    vk = VerifyingKey(Domain(k), fixed, sigma, int(str(z["transcript_repr"])))
    chip_smoke.vk_parity("phase x", workload, circuit, vk, "b16", 1.5)
    assert f"phase x vk_parity k={k} base=b16 equal=true: {workload}" in capsys.readouterr().out
    bad = [VerifyingKey(Domain(k), fixed, [sigma[1], sigma[0], *sigma[2:]], vk.transcript_repr),
           VerifyingKey(Domain(k), fixed, sigma, vk.transcript_repr + 1)]
    for wrong in bad:
        with pytest.raises(AssertionError, match="differ from the JAX package's"):
            chip_smoke.vk_parity("phase x", workload, circuit, wrong, "b4", 1.5)
        assert f"vk_parity k={k} base=b4 equal=false" in capsys.readouterr().out


def test_chip_smoke_checks_every_golden():
    """chip_smoke.py holds the card's vk to every committed golden."""
    assert sorted(chip_smoke.VK_GOLDENS) == COMMITTED
    for workload, k in COMMITTED:
        assert chip_smoke.VK_GOLDEN.format(workload, k) == golden_path(workload, k)


@pytest.mark.slow
@pytest.mark.parametrize("row", COMMITTED, ids=[f"{w}-k{k}" for w, k in COMMITTED])
def test_vk_golden_matches_jax(row):
    want = jax_golden(*row)
    have = load(*row)
    assert set(want) == set(have)
    for key in want:
        assert np.array_equal(want[key], have[key]), key


if __name__ == "__main__":
    w, kk = sys.argv[1], int(sys.argv[2])
    t0 = time.time()
    arrays = jax_golden(w, kk)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(golden_path(w, kk), **arrays)
    print(f"wrote {golden_path(w, kk)}: {os.path.getsize(golden_path(w, kk))} bytes in "
          f"{time.time() - t0:.1f} s")
