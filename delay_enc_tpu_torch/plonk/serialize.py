"""Proving and verifying keys on disk, in the JAX package's files.

Counterpart of `delay_enc_tpu/plonk/serialize.py`: the same npz files, key
for key, dtype for dtype, shape for shape, so a key written by either
package is read by the other.  Every field element is stored as the JAX
package's (…, 16) uint32 16-bit limbs of its Montgomery form
(`state.to_jax_limbs`); `load_pk` rebuilds the port's key on the device
through `state.proving_key_from_jax`.
"""

from __future__ import annotations

import os

import numpy as np

from ..curves.bn254 import g1_from_bytes, g1_to_bytes
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.ntt import powers
from ..utils.device import resolve
from .domain import Domain
from .keygen import ALL_FIXED, ProvingKey, VerifyingKey, transcript_repr


def _atomic_savez(path: str, compressed: bool = True, **arrays) -> None:
    """Write to a temporary file, then rename: two writers of one key (a
    daemon and a keygen beside it) write the same bytes, and a reader never
    sees a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)
    os.replace(tmp, path)


def save_vk(vk: VerifyingKey, path: str) -> None:
    """npz: k, fixed (15, 32) and sigma (6, 32) uint8 compressed points."""
    pts = lambda ps: np.stack([np.frombuffer(g1_to_bytes(p), dtype=np.uint8) for p in ps])
    _atomic_savez(path, k=vk.domain.k,
                  fixed=pts([vk.fixed_commitments[n] for n in ALL_FIXED]),
                  sigma=pts(vk.sigma_commitments))


def load_vk(path: str) -> VerifyingKey:
    """Read a vk file of either package.  transcript_repr is recomputed,
    never read: a file cannot bind a digest that its points do not give."""
    z = np.load(path)
    fixed = {name: g1_from_bytes(z["fixed"][i].tobytes()) for i, name in enumerate(ALL_FIXED)}
    sigma = [g1_from_bytes(row.tobytes()) for row in z["sigma"]]
    domain = Domain(int(z["k"]))
    return VerifyingKey(domain, fixed, sigma, transcript_repr(domain, fixed, sigma))


def zeta_inv_powers(pk: ProvingKey):
    """(n_ext, 8) zeta^-i, the JAX key's field.  The port keeps zeta^-i /
    n_ext (`quotient_unscale`) instead, so the file's field is made again."""
    domain = pk.vk.domain
    return powers(L.FR_CTX, FR.inv(domain.zeta), domain.n_ext, pk.device)


# the keyed circuit's `keygen.circuit_shape`, a field of the port's files
# only: the JAX package's load_pk reads its fields by name and passes over it
SHAPE_FIELD = "port_circuit_shape"


def _shape_to_array(shape: tuple) -> np.ndarray:
    """(rows, lookup widths, public inputs, copies) -> int64 [rows, public
    inputs, copies, *widths]."""
    rows, widths, n_instance, n_copies = shape
    return np.array([rows, n_instance, n_copies, *widths], dtype=np.int64)


def _shape_from_array(a: np.ndarray) -> tuple:
    v = [int(x) for x in a]
    return (v[0], tuple(v[3:]), v[1], v[2])


def save_pk(pk: ProvingKey, path: str, compressed: bool = False) -> None:
    """Write `path.pk.npz` and `path.vk.npz`, as the JAX package's save_pk
    does: fused keys with their extended-coset tables (`fe_*`, `se_*`,
    `*_ext`), split keys with the Lagrange columns' coefficients (`l*_coeff`);
    and the keyed circuit's shape (`SHAPE_FIELD`), which the JAX package
    does not read.
    Plain npz by default: deflate takes minutes over a k=16 key (1.09 GB)
    for a third off its size; np.load reads either kind, so both packages
    read both."""
    g = lambda t: L.words_to_limbs_np(L.to_numpy(t))
    arrays = {
        "k": np.int64(pk.vk.domain.k),
        "split": np.bool_(pk.split),
        "zeta_inv_powers": g(zeta_inv_powers(pk)),
        "delta_powers": np.array([str(d) for d in pk.delta_powers]),
    }
    if pk.split:
        arrays.update(l0_coeff=g(pk.l0_coeff), l_last_coeff=g(pk.l_last_coeff),
                      l_blind_coeff=g(pk.l_blind_coeff))
    else:
        arrays.update(l0_ext=g(pk.l0_ext), l_last_ext=g(pk.l_last_ext),
                      l_blind_ext=g(pk.l_blind_ext), x_ext=g(pk.x_ext),
                      zeta_powers=g(pk.zeta_powers), zh_inv_ext=g(pk.zh_inv_ext))
    for name in ALL_FIXED:
        arrays[f"fr_{name}"] = g(pk.fixed_raw[name])
        arrays[f"fc_{name}"] = g(pk.fixed_coeff[name])
        if not pk.split:
            arrays[f"fe_{name}"] = g(pk.fixed_ext[name])
    for c in range(len(pk.sigma_coeff)):
        arrays[f"sc_{c}"] = g(pk.sigma_coeff[c])
        if not pk.split:
            arrays[f"se_{c}"] = g(pk.sigma_ext[c])
    if pk.shape is not None:
        arrays[SHAPE_FIELD] = _shape_to_array(pk.shape)
    _atomic_savez(path + ".pk.npz", compressed, **arrays)
    save_vk(pk.vk, path + ".vk.npz")


def load_pk(path: str, device="cuda") -> ProvingKey:
    """Read `path.pk.npz` and `path.vk.npz` of either package onto `device`.
    A file the port wrote gives the keyed circuit's `shape`, which the
    batched prover holds every builder to; a file of the JAX package has
    none (`shape` None), and the batch is then held to its first builder."""
    from ..state import proving_key_from_jax

    device = resolve(device)
    vk = load_vk(path + ".vk.npz")
    with np.load(path + ".pk.npz") as z:
        split = bool(z["split"]) if "split" in z.files else False
        nsig = len(vk.sigma_commitments)
        fields = {
            "k": int(z["k"]),
            "split": split,
            "fixed_commitments": vk.fixed_commitments,
            "sigma_commitments": vk.sigma_commitments,
            "transcript_repr": vk.transcript_repr,
            "delta_powers": [int(d) for d in z["delta_powers"]],
            "zeta_inv_powers": z["zeta_inv_powers"],
            "fixed_raw": {n: z[f"fr_{n}"] for n in ALL_FIXED},
            "fixed_coeff": {n: z[f"fc_{n}"] for n in ALL_FIXED},
            "sigma_coeff": [z[f"sc_{c}"] for c in range(nsig)],
        }
        if SHAPE_FIELD in z.files:
            fields["shape"] = _shape_from_array(z[SHAPE_FIELD])
        if split:
            fields.update({name: z[name] for name in ("l0_coeff", "l_last_coeff",
                                                      "l_blind_coeff")})
        else:
            fields["fixed_ext"] = {n: z[f"fe_{n}"] for n in ALL_FIXED}
            fields["sigma_ext"] = [z[f"se_{c}"] for c in range(nsig)]
            fields.update({name: z[name] for name in ("l0_ext", "l_last_ext", "l_blind_ext",
                                                      "x_ext", "zeta_powers", "zh_inv_ext")})
        return proving_key_from_jax(fields, device)
