"""Smoke run of delay_enc_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (stderr carries detail):
 0. the card's name and power limit; build the CUDA kernels;
 1. each kernel against its plain PyTorch version on the card, bit-exact,
    at the main path's shapes, with both times;
 2. artefacts of the JAX package: the committed k=11 SRS, a keygen of
    pose_enc that must reproduce the committed vk, the committed proof;
 3. pose_enc at k=11: keygen, two proofs from default_rng(0) that must be
    byte-identical, verify;
 4. delay_enc at k=16, the headline: SRS setup, keygen, create_proof,
    verify, with every kernel's launch count from this phase; then one more
    proof under torch.profiler for the device time by kernel;
then the kernels' JSON line, the card's line, and the result line.  Any
failure raises and exits non-zero.  Without a CUDA device it exits
non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "bench_data_cpu")
VK_FILE = "keys_pose_enc_03b0f1e6255bb975e1394ff696635139.vk.npz"
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
INT_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock
WIDE = 2  # a 32x32->64 product counted as two integer multiply-adds
MONT_MULS = 128  # wide products in one 8-word CIOS Montgomery product
ADD_MULS = 12  # Montgomery products in one complete addition


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    d = ((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max().item()
    return int(d)


def affine_words(pts) -> np.ndarray:
    """(…, 3, 8) projective tensor -> canonical affine words for comparison."""
    from delay_enc_tpu_torch.ops import msm as M

    out = []
    for p in M.points_from_device(pts):
        x, y = p if p is not None else (0, 0)
        out.append([(v >> (32 * i)) & 0xFFFFFFFF for v in (x, y) for i in range(8)])
    return np.asarray(out, dtype=np.int64)


class Report:
    def __init__(self, int_rate: float):
        self.int_rate = int_rate  # integer multiply-adds per second
        self.rows = {}

    def add(self, name, *, err, ms, plain_ms, nbytes, int_ops, note=""):
        from delay_enc_tpu_torch.ops import _cuda

        k = _cuda.KERNELS[name]
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = int_ops / self.int_rate * 1e3
        self.rows[name] = {
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        print(f"phase 1 {name}: max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {self.rows[name]['bound_ms']:.4f} ms ({self.rows[name]['bound_by']}){note}",
              flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def phase1(rep: Report, dev):
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import msm as M
    from delay_enc_tpu_torch.ops import msm_tree as MT
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.plonk.domain import Domain

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand_field(ctx, n):
        """n random reduced elements (Montgomery of random values) plus 0, 1, p-1."""
        w = torch.randint(-2**31, 2**31, (n, 8), generator=gen, device=dev, dtype=torch.int64)
        w = w.to(torch.int32)
        w[:, 7] &= 0x0FFFFFFF  # below 2^252 < p
        edge = L.to_device_mont(ctx, [0, 1, ctx.p - 1], dev)
        return torch.cat([w, edge])

    # K-a at 2^20 elements of Fr and Fq, elementwise and with a broadcast scalar
    n = 1 << 20
    for op, name in ((L.mont_mul, "field_mont_mul"), (L.add, "field_add"),
                     (L.sub, "field_sub")):
        plain = {L.mont_mul: L.mont_mul_plain, L.add: L.add_plain, L.sub: L.sub_plain}[op]
        err, ms, plain_ms = 0, 0.0, 0.0
        for ctx in (L.FR_CTX, L.FQ_CTX):
            a, b = rand_field(ctx, n), rand_field(ctx, n).flip(0)
            for bb in (b, b[5:6]):
                got = op(ctx, a, bb)
                t0 = time.time()
                want = plain(ctx, a, bb)
                torch.cuda.synchronize()
                plain_ms += (time.time() - t0) * 1e3 / 4
                err = max(err, max_err(got, want))
            ms += timed(lambda: op(ctx, a, b), 20) / 2
        elems = n + 3
        rep.add(name, err=err, ms=ms, plain_ms=plain_ms, nbytes=96 * elems,
                int_ops=elems * (MONT_MULS * WIDE if op is L.mont_mul else 0),
                note=" (Fr and Fq, 2^20 + 3 elements)")

    # K-b: (19, 2^19) forward coset transform, (6, 2^16) inverse
    d = Domain(16)
    plan, plan_ext = d.plan(dev), d.plan_ext(dev)
    ext_in = rand_field(L.FR_CTX, 19 * (1 << 19) - 3).reshape(19, 1 << 19, 8)
    inv_in = rand_field(L.FR_CTX, 6 * (1 << 16) - 3).reshape(6, 1 << 16, 8)
    err, plain_ms, ms, ops, nbytes = 0, 0.0, 0.0, 0, 0
    for x, tw in ((ext_in, plan_ext.tw), (inv_in, plan.tw_inv)):
        got = N.stockham(L.FR_CTX, x, tw)
        t0 = time.time()
        want = N.stockham_plain(L.FR_CTX, x, tw)
        torch.cuda.synchronize()
        plain_ms += (time.time() - t0) * 1e3
        err = max(err, max_err(got, want))
        del want
        ms += timed(lambda: N.stockham(L.FR_CTX, x, tw), 3)
        b_, n_ = x.shape[0], x.shape[1]
        k_ = n_.bit_length() - 1
        ops += b_ * k_ * (n_ // 2) * MONT_MULS * WIDE
        nbytes += 2 * x.numel() * 4 + (n_ // 2) * 32
    rep.add("ntt_stage", err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes, int_ops=ops,
            note=" (whole transforms: (19, 2^19) forward + (6, 2^16) inverse)")
    del ext_in, inv_in

    # K-d: 2^16 pairs with identities, doublings and P + (-P)
    g = M.base_table((1, 2), dev)[:128]  # 2^b * G
    idx = torch.randint(0, 128, (2, 1 << 16), generator=gen, device=dev)
    p, q = g[idx[0]].clone(), g[idx[1]].clone()
    p[:64] = M.identity_proj(dev)
    q[64:128] = p[64:128]
    q[128:192] = torch.stack([p[128:192, 0], L.neg(L.FQ_CTX, p[128:192, 1]), p[128:192, 2]], 1)
    got = M.complete_add(p, q)
    t0 = time.time()
    want = M.complete_add_plain(p, q)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_err(got, want)
    ms = timed(lambda: M.complete_add(p, q), 20)
    npts = 1 << 16
    rep.add("g1_complete_add", err=err, ms=ms, plain_ms=plain_ms, nbytes=3 * 96 * npts,
            int_ops=npts * ADD_MULS * MONT_MULS * WIDE, note=" (2^16 pairs)")

    # K-c: selector mode, C = 16 rows of W = 2^15 lanes over a pair table
    w = 1 << 15
    pts = M.fixed_base_batch_mul(M.base_table((1, 2), dev),
                                 torch.randint(0, 2**31, (2 * w, 8), generator=gen,
                                               device=dev, dtype=torch.int64).to(torch.int32)
                                 & 0x0FFFFFFF)
    table = M.pair_tables(pts)
    sel = torch.randint(0, 16, (16, w), generator=gen, device=dev, dtype=torch.int64).to(torch.uint8)
    got = MT.tree_reduce(table, sel)
    t0 = time.time()
    want = MT.tree_reduce_plain(table, sel)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = int(np.abs(affine_words(got) - affine_words(want)).max())
    ms = timed(lambda: MT.tree_reduce(table, sel), 5)
    rep.add("plane_sums", err=err, ms=ms, plain_ms=plain_ms,
            nbytes=16 * w + 16 * w * 96 + 16 * 96,
            int_ops=16 * (w - 1) * ADD_MULS * MONT_MULS * WIDE,
            note=" (selector mode, C=16, W=2^15, compared affine)")


def pose_enc_circuit(seed: int = 42):
    """bench.py build_circuit("pose_enc") with the utils/config.py defaults."""
    from delay_enc_tpu_torch.encryption import PoseidonCipher
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.models import PoseidonEncCircuit
    from delay_enc_tpu_torch.poseidon import get_spec
    from delay_enc_tpu_torch.utils.config import CircuitConfig

    cc = CircuitConfig()
    rng = np.random.default_rng(seed)
    spec = get_spec(FR, cc.t, cc.rate, cc.r_f, cc.r_p)
    msg = cc.message_capacity
    key = (FR.random(rng), FR.random(rng))
    message = [0] * msg
    expected = PoseidonCipher(spec, key, capacity=msg).encrypt(message, 1)
    return PoseidonEncCircuit(spec=spec, num_input=msg, message=message, key=key,
                              expected=expected, capacity=msg).build()


def delay_enc_circuit(seed: int = 42):
    """bench.py build_circuit("delay_enc", k=16): the default 5-bit window."""
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.models import DelayEncryptCircuit
    from delay_enc_tpu_torch.poseidon import get_spec
    from delay_enc_tpu_torch.utils.config import CircuitConfig

    cc = CircuitConfig()
    rng = np.random.default_rng(seed)
    spec = get_spec(FR, cc.t, cc.rate, cc.r_f, cc.r_p)

    def rand_bits(bits):
        v = 0
        while v.bit_length() != bits:
            nbytes = (bits + 7) // 8
            v = int.from_bytes(bytes(rng.integers(0, 256, nbytes, dtype="uint8")), "little")
            v &= (1 << bits) - 1
        return v

    n = rand_bits(cc.bits_len)
    e = int(rng.integers(1, 1 << cc.exp_limb_bits))
    x = rand_bits(cc.bits_len) % n
    return DelayEncryptCircuit(n=n, e=e, x=x, spec=spec, num_input=2, message=[0, 0],
                               exp_limb_bits=cc.exp_limb_bits).build()


def spans(prefix=""):
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    return {k: round(v, 4) for k, v in GLOBAL_METRICS.spans.items() if k.startswith(prefix)}


KERNEL_SYMBOLS = {  # CUDA kernel name prefix -> the port's kernel
    "field_binary_kernel": "field (K-a)", "ntt_stage_kernel": "ntt_stage (K-b)",
    "plane_sums_kernel": "plane_sums (K-c)", "g1_add_kernel": "g1_complete_add (K-d)",
}


def profile_proof(srs, pk, builder, proof, dev):
    """One more headline proof under torch.profiler: device kernel time by
    kernel (the port's four, and PyTorch's own copies and elementwise ops)
    against the proof's wall time, so the device's idle share shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delay_enc_tpu_torch.plonk import create_proof

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        again = create_proof(srs, pk, builder, np.random.default_rng(0), device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    if again != proof:
        raise AssertionError("the profiled proof differs from the first")
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        name = next((v for k, v in KERNEL_SYMBOLS.items() if k in e.key), "torch (other)")
        g = groups.setdefault(name, [0.0, 0])
        g[0] += us / 1e3
        g[1] += e.count
    busy = sum(g[0] for g in groups.values())
    if busy == 0:
        print(f"phase 4 profile: proof wall {wall_ms:.3f} ms; the profiler saw no device "
              f"time, idle share not measured", flush=True)
        return
    detail = {k: {"ms": round(v[0], 4), "kernels": v[1]} for k, v in sorted(groups.items())}
    print(f"phase 4 profile: proof wall {wall_ms:.3f} ms under the profiler, device kernels "
          f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.4f}; {json.dumps(detail)}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"phase 0 card: {card}", flush=True)

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, load_vk, min_k
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    t0 = time.time()
    _cuda.build(force=True)
    print(f"phase 0 build: {time.time() - t0:.2f} s for {len(_cuda.SOURCES)} sources", flush=True)
    for name in _cuda.SOURCES:
        with open(os.path.join(_cuda.BUILD, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = sm_count * INT_PER_SM_CLK * clock_mhz * 1e6
    log(f"integer rate: {sm_count} SMs x {INT_PER_SM_CLK} x {clock_mhz} MHz = {int_rate:.4g}/s")
    rep = Report(int_rate)
    phase1(rep, dev)
    torch.cuda.empty_cache()

    # ---- 2. artefacts of the JAX package ------------------------------
    t0 = time.time()
    srs11 = SRS.load(os.path.join(DATA, "srs_bn254_k11.npz"), device=dev)
    b11 = pose_enc_circuit()
    k11 = max(min_k(b11), 11)
    pk11, vk11 = keygen(b11, srs11, k=k11, device=dev)
    want = load_vk(os.path.join(DATA, VK_FILE))
    if k11 != want.domain.k:
        raise AssertionError(f"pose_enc k={k11}, committed vk k={want.domain.k}")
    for name in ALL_FIXED:
        if vk11.fixed_commitments[name] != want.fixed_commitments[name]:
            raise AssertionError(f"fixed commitment {name} differs from the committed vk")
    if vk11.sigma_commitments != want.sigma_commitments:
        raise AssertionError("sigma commitments differ from the committed vk")
    if vk11.transcript_repr != want.transcript_repr:
        raise AssertionError("transcript_repr differs from the committed vk")
    with open(os.path.join(DATA, "proof_pose_enc_k11.bin"), "rb") as f:
        jax_proof = f.read()
    if not verify_proof(SRS.load_host_meta(os.path.join(DATA, "srs_bn254_k11.npz")), want,
                        jax_proof):
        raise AssertionError("the committed JAX proof does not verify")
    print(f"phase 2 artefacts: keygen reproduces the committed vk "
          f"({len(ALL_FIXED)} fixed + {len(want.sigma_commitments)} sigma), "
          f"committed proof verifies ({time.time() - t0:.2f} s)", flush=True)

    # ---- 3. pose_enc k=11 ---------------------------------------------
    GLOBAL_METRICS.spans.clear()
    t0 = time.time()
    pk11, vk11 = keygen(b11, srs11, k=k11, device=dev)
    t_key = time.time() - t0
    proofs, t_prove = [], []
    for _ in range(2):
        t0 = time.time()
        proofs.append(create_proof(srs11, pk11, b11, np.random.default_rng(0), device=dev))
        t_prove.append(time.time() - t0)
    if proofs[0] != proofs[1]:
        raise AssertionError("pose_enc proofs from one rng seed differ")
    t0 = time.time()
    if not verify_proof(srs11, vk11, proofs[0]):
        raise AssertionError("pose_enc proof does not verify")
    t_ver = time.time() - t0
    print(f"phase 3 pose_enc k={k11}: rows={b11.rows} keygen {t_key:.3f} s, prove "
          f"{t_prove[0]:.3f} s then {t_prove[1]:.3f} s (identical bytes), verify {t_ver:.3f} s, "
          f"proof {len(proofs[0])} B; spans {json.dumps(spans())}", flush=True)
    del pk11, srs11

    # ---- 4. delay_enc k=16, the main path -----------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    GLOBAL_METRICS.spans.clear()
    t0 = time.time()
    b16 = delay_enc_circuit()
    t_build = time.time() - t0
    k16 = max(min_k(b16), 16)
    _cuda.reset_launches()
    t0 = time.time()
    srs16 = SRS.setup(k16, tau=0x5EED_0F_DE1A7, device=dev)
    t_srs = time.time() - t0
    t0 = time.time()
    pk16, vk16 = keygen(b16, srs16, k=k16, device=dev)
    t_key = time.time() - t0
    t0 = time.time()
    proof16 = create_proof(srs16, pk16, b16, np.random.default_rng(0), device=dev)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    launches = _cuda.launch_counts()
    t0 = time.time()
    ok = verify_proof(srs16, vk16, proof16)
    t_ver = time.time() - t0
    if not ok:
        raise AssertionError("delay_enc proof does not verify")
    print(f"phase 4 delay_enc k={k16}: rows={b16.rows} circuit build {t_build:.3f} s (host), "
          f"SRS setup {t_srs:.3f} s, keygen {t_key:.3f} s, prove {t_prove:.3f} s, "
          f"verify {t_ver:.3f} s (host), proof {len(proof16)} B, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; spans {json.dumps(spans())}; "
          f"launches {json.dumps(launches)}", flush=True)

    profile_proof(srs16, pk16, b16, proof16, dev)

    # ---- 5. kernels ---------------------------------------------------
    for name, row in rep.rows.items():
        row["launches"] = launches.get(name, 0)
    missing = [name for name, row in rep.rows.items() if row["launches"] == 0]
    print(json.dumps({"kernels": list(rep.rows.values())}), flush=True)
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
