"""Every sharded path once over a mesh, each result checked.

The port's counterpart of `__graft_entry__.py:55 dryrun_multichip`:

    python -m delay_enc_tpu_torch.parallel.dryrun [-n D] [--shared] [--device cpu] [--fast]

In order: the sharded NTT there and back at k = max(12, 2m) (D = 2^m), the
sharded MSM of 2^k points against the host's `G1.multi_scalar_mul`, a batch
of D proofs of a k=7 test circuit split over the mesh, each verified, and
(unless `fast`) pose_enc at k=11, D proofs over the mesh, checked by
`verify_proofs_batched`, every proof different.  The JAX package's
`DELAY_ENC_DRYRUN_FAST` environment variable is the `fast` argument here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .mesh import Mesh, make_mesh


def _tiny_circuit(x0: int, y0: int):
    from ..cs import Builder, MainGate, RangeChip
    from ..fields.bn254 import FR

    b = Builder(FR)
    mg = MainGate(b)
    rc = RangeChip(b)
    x = mg.assign_value(x0)
    y = mg.assign_value(y0)
    mg.assert_equal(mg.mul(x, y), mg.assign_value(x0 * y0 % FR.p))
    rc.assign(45, 2, 6)
    return b


def dryrun_multichip(n_devices: int, devices=None, fast: bool = False) -> None:
    """Run every sharded path over a mesh of n_devices shards: the first
    n_devices cards (`make_mesh`), or the given devices, which may name one
    device several times.  Raises on any mismatch."""
    from ..curves.bn254 import G1, G1_GEN
    from ..fields.bn254 import FR
    from ..ops import limbs as L
    from ..ops import msm as M
    from ..plonk import SRS, create_proofs_batched, keygen, verify_proof
    from .msm import sharded_plane_sums
    from .ntt import ShardedNTTPlan, sharded_intt, sharded_ntt

    mesh = make_mesh(n_devices) if devices is None else Mesh(tuple(devices))
    if mesh.size != n_devices:
        raise ValueError(f"{mesh.size} devices given for {n_devices} shards")
    dev = mesh.devices[0]
    k = max(12, 2 * (n_devices.bit_length() - 1))  # D^2 <= N
    n = 1 << k
    plan = ShardedNTTPlan.make(k, n_devices, mesh.devices)
    rng = np.random.default_rng(0)

    coeffs_h = [FR.random(rng) for _ in range(n)]
    host_pts = [G1.mul(G1_GEN, int(rng.integers(1, 1 << 50))) for _ in range(n)]
    scalars_h = [FR.random(rng) for _ in range(n)]
    coeffs = L.to_device_mont(L.FR_CTX, coeffs_h, dev)
    pts = M.points_to_device(host_pts, dev)
    scalars = M.scalars_to_words(scalars_h, dev)

    t0 = time.time()
    back = mesh.gather(sharded_intt(mesh, plan, sharded_ntt(mesh, plan, coeffs)))
    if not torch.equal(back, coeffs):
        raise AssertionError("sharded NTT roundtrip mismatch")
    sums = sharded_plane_sums(mesh, pts, scalars)
    (got,) = M.fold_planes_host(sums[None], base_bits=2)
    if got != G1.multi_scalar_mul(scalars_h, host_pts):
        raise AssertionError("sharded MSM mismatch")
    print(f"dryrun: k={k} sharded NTT roundtrip and MSM over {n_devices} shards "
          f"{time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    srs = SRS.setup(7, tau=424242, device=dev)
    builders = [_tiny_circuit(3 + i, 5 + i) for i in range(n_devices)]
    pk, vk = keygen(builders[0], srs, device=dev)
    proofs = create_proofs_batched(srs, pk, builders, np.random.default_rng(0), mesh=mesh,
                                   axis=mesh.axis)
    if not all(verify_proof(srs, vk, p) for p in proofs):
        raise AssertionError("batched proof failed")
    print(f"dryrun: k=7 batched prove+verify {time.time() - t0:.1f}s", flush=True)

    if not fast:
        from ..encryption import PoseidonCipher
        from ..models import PoseidonEncCircuit
        from ..plonk import verify_proofs_batched
        from ..poseidon import get_spec

        t0 = time.time()
        spec = get_spec(FR, 5, 4, 8, 57)
        key = (FR.random(rng), FR.random(rng))
        expected = PoseidonCipher(spec, key).encrypt([0, 0], 1)
        pose = PoseidonEncCircuit(spec=spec, num_input=2, message=[0, 0], key=key,
                                  expected=expected).build()
        srs11 = SRS.setup(11, tau=424243, device=dev)
        pk11, vk11 = keygen(pose, srs11, k=11, device=dev)
        print(f"dryrun: k=11 srs+keygen {time.time() - t0:.1f}s", flush=True)
        t0 = time.time()
        proofs = create_proofs_batched(srs11, pk11, [pose] * n_devices,
                                       np.random.default_rng(1), mesh=mesh, axis=mesh.axis)
        dt = time.time() - t0
        if not verify_proofs_batched(srs11, vk11, proofs):
            raise AssertionError("k=11 batched proofs failed")
        if len(set(proofs)) != len(proofs):
            raise AssertionError("blinding must differ per instance")
        print(f"dryrun: k=11 pose_enc x{n_devices} sharded prove+verify {dt:.1f}s "
              f"({n_devices / dt:.2f} proofs/s)", flush=True)
    print(f"dryrun_multichip({n_devices}): ok", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=None,
                    help="shards (default: every card, or 2 with --shared)")
    ap.add_argument("--shared", action="store_true",
                    help="all shards on one device (a one-card machine, or the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (cpu needs --shared)")
    ap.add_argument("--fast", action="store_true", help="leave out pose_enc k=11")
    args = ap.parse_args(argv)
    if args.shared:
        n = args.n or 2
        devices = Mesh.shared(args.device, n).devices
    else:
        mesh = make_mesh(args.n, args.device)
        n, devices = mesh.size, mesh.devices
    dryrun_multichip(n, devices=devices, fast=args.fast)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
