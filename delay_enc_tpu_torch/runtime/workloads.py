"""The benchmark's statements and the key cache, as the port's own copy.

The JAX package's `bench.py` draws each workload's circuit from a seed
(`build_circuit`), names the exponent bits of each row (`T_BITS`), caches
keys under a hash of the circuit (`get_keys`) and banks a verified proof
(`_save_proof_artifact`).  This module does the same with the port's
modules: the same draws give the same circuits, and `key_path` gives the
same file names, so a key cache written by either package is found by the
other.  It reads no environment variable: the circuit settings are the
defaults of `utils/config.py`.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

from ..utils.device import resolve
from ..utils.timers import GLOBAL_METRICS

# Exponent bits |T| of each (workload, k) row of the reference's published
# sweep (bench.py T_BITS): the reference grows the circuit with k by
# widening the exponent.
T_BITS = {
    ("delay_enc", 16): 5,
    ("delay_enc", 17): 15,
    ("delay_enc", 18): 31,
    ("delay_enc", 19): 32,
    ("mod_pow", 16): 5,
    ("mod_pow", 17): 8,
    ("mod_pow", 18): 31,
    ("mod_pow", 19): 33,
}


def rand_bits(rng, bits: int) -> int:
    """An integer of exactly `bits` bits, rejection-sampled from bytes
    (bench.py's draw, value for value)."""
    v = 0
    while v.bit_length() != bits:
        nbytes = (bits + 7) // 8
        v = int.from_bytes(bytes(rng.integers(0, 256, nbytes, dtype="uint8")), "little")
        v &= (1 << bits) - 1
    return v


def build_circuit(workload: str, k: int | None = None, seed: int = 42,
                  t_bits: int | None = None, msg: int = 2):
    """bench.py build_circuit with the default circuit settings: "pose_enc"
    (a Poseidon encryption of `msg` zero elements), "mod_pow" or
    "delay_enc" (a 2048-bit modulus and an exponent of T_BITS[(workload,
    k)] bits, the default 5-bit window where no row names k).  Returns the
    built cs.Builder."""
    from ..fields import FR
    from ..poseidon import get_spec
    from ..utils.config import CircuitConfig

    cc = CircuitConfig()
    rng = np.random.default_rng(seed)
    spec = get_spec(FR, cc.t, cc.rate, cc.r_f, cc.r_p)
    if workload == "pose_enc":
        from ..encryption import PoseidonCipher
        from ..models import PoseidonEncCircuit

        key = (FR.random(rng), FR.random(rng))
        message = [0] * msg
        expected = PoseidonCipher(spec, key, capacity=msg).encrypt(message, 1)
        return PoseidonEncCircuit(spec=spec, num_input=msg, message=message, key=key,
                                  expected=expected, capacity=msg).build()
    if workload not in ("mod_pow", "delay_enc"):
        raise ValueError(f"unknown workload {workload!r}: pose_enc, mod_pow or delay_enc")
    if t_bits is None:
        t_bits = T_BITS.get((workload, k), cc.exp_limb_bits)
    n = rand_bits(rng, cc.bits_len)
    if t_bits == cc.exp_limb_bits:
        e = int(rng.integers(1, 1 << t_bits))  # the default window (bench.py keeps this draw)
    else:
        e = rand_bits(rng, t_bits) | (1 << (t_bits - 1))  # |T| bits, the top one set
    x = rand_bits(rng, cc.bits_len) % n
    if workload == "mod_pow":
        from ..models import RSACircuit

        return RSACircuit(n=n, e=e, x=x, field=FR, exp_limb_bits=t_bits).build()
    from ..models import DelayEncryptCircuit

    return DelayEncryptCircuit(n=n, e=e, x=x, spec=spec, num_input=2, message=[0, 0],
                               exp_limb_bits=t_bits).build()


def key_path(workload: str, builder, k: int, cache_dir: str) -> str:
    """The key cache's path stem for a circuit: bench.py's hash of the
    format version, workload, k, rows and the first 2048 values of four
    fixed columns."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v2:{workload}:{k}:{builder.rows}".encode())
    for name in ("q_a", "q_mul_ab", "q_constant", "tag_a"):
        h.update(str(builder.fixed[name][:2048]).encode())
    return os.path.join(cache_dir, f"keys_{workload}_{h.hexdigest()}")


def get_keys(workload: str, builder, srs, k: int, cache_dir: str, msm: str = "b4",
             split: bool | None = None, device="cuda"):
    """(pk, vk, key_path): the cached key if `key_path.pk.npz` exists, else
    keygen, whose key is then saved there.  The steps are spans inside the
    span `keys`: `keys/load_pk`, or keygen's own `keys/keygen` and
    `keys/save_pk`."""
    from ..plonk import keygen
    from ..plonk.serialize import load_pk, save_pk

    device = resolve(device)
    path = key_path(workload, builder, k, cache_dir)
    with GLOBAL_METRICS.span("keys"):
        if os.path.exists(path + ".pk.npz"):
            with GLOBAL_METRICS.span("load_pk", device):
                pk = load_pk(path, device)
            print(f"# keys {os.path.basename(path)} loaded", file=sys.stderr, flush=True)
            return pk, pk.vk, path
        pk, vk = keygen(builder, srs, k=k, split=split, device=device, msm=msm)
        os.makedirs(cache_dir, exist_ok=True)
        with GLOBAL_METRICS.span("save_pk"):
            save_pk(pk, path)
    print(f"# keys {os.path.basename(path)} made and saved, "
          f"{os.path.getsize(path + '.pk.npz')} bytes", file=sys.stderr, flush=True)
    return pk, vk, path


def save_proof_artifact(cache_dir: str, workload: str, k: int, key_path: str, proof: bytes,
                        srs_dir: str | None = None) -> str:
    """Bank a verified proof beside its key, as bench.py does:
    `proof_{workload}_k{k}.bin` and a `.json` naming the vk, the proof and
    the SRS file (a proof verifies only against the SRS of its keys).
    Returns the stem."""
    base = os.path.join(cache_dir, f"proof_{workload}_k{k}")
    srs = os.path.join(srs_dir or cache_dir, f"srs_bn254_k{k}.npz")
    with open(base + ".bin", "wb") as f:
        f.write(proof)
    with open(base + ".json", "w") as f:
        json.dump({"vk": key_path + ".vk.npz", "proof": base + ".bin", "srs": srs,
                   "workload": workload, "k": k}, f)
    return base
