"""Smoke run of delay_enc_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (stderr carries detail):
 0. the card's name and power limit; whether the host C libraries
    (`native.get_lib`, `get_eclib`, `get_pyints`) loaded, which they must;
    build the CUDA kernels; then SRS setup,
    keygen and create_proof of the k=7 test circuit on the card, whose vk
    and proof bytes must equal the JAX package's (tests/data/torch_port_k7.npz),
    with ntt="mxu" too;
    the batched proofs of two witnesses in both MSM bases, which must equal
    the JAX package's batch (tests/data/torch_port_batch_k7.npz), and three
    proofs pipelined two deep, which must equal the serial ones;
 1. each kernel against its plain PyTorch version on the card, bit-exact
    (points as affine), at the main path's shapes and on carry-heavy
    operands, with both times; field_pow (inv, mont_pow) at 2^16 elements of
    Fr and Fq to five exponents, one launch a call, and batch_inv with
    zeros inside; field_wide_to_mont at 2^18 rows of 64 bytes; then the
    field_pow path (inv, mont_pow, batch_inv and batch_inv_log through
    their entry points, launches counted); the
    multi-stage NTT also at small and odd k,
    at batch 1 and with its fused input and output sides; the scan kernel in
    every form, at ragged lengths, in one row of 2^20, with a zero inside and
    as powers, every form of more than one tile 50 times over (the look-back
    is a race between blocks); K7's two contractions at the delay_enc
    openings' stacks (47, 6 and 4 rows of 2^16), 50 times over, and at ragged
    lengths against the plain version on the CPU; the
    plane sums of both bases (K-c over the base-4 table, plane_sums16 over
    the base-16 one, every selector value among the rows) also alone at the
    proof's own shapes, at a ragged width, at one lane and at one row; the
    selector kernel at both digit widths with 0, 1, r - 1 and 2^253 among
    the scalars; the fractions (K5) and quotient (K6) kernels also at small
    sizes against their plain versions on the CPU; the split quotient's forms
    at k=18: K6's coset form (rot 1, stored at 8i + j of a 2^21 h_ext) at
    cosets 0 and 7, K-b over (43, 2^18) with a coset's power table and the
    2^21 inverse with the unscale table; K5, K6 and K7 over an instance axis
    (B = 4 at the path's shapes, each instance with its own challenges, and
    at small ragged sizes against the CPU) and against their single
    launches; K12's two kernels, the cross-shard stages and the reshuffle,
    forward and inverse, at delay_enc k=16 over 4 shards (L = 2^14) with all
    shards on the card and with each single shard and some pairs as the
    card's own, at D = 2 and D = 8, and at k=20 over 4 (L = 2^18); K11 (the
    matmul NTT): its product and split at the (6, 2^16)
    forward against their plain versions with torch._int_mm over the same
    plane products as the library's time, every fold at k = 4..10 against
    the four-step plain version, and against K-b at the proof's transforms
    and at 2^20, its reduction on adversarial columns; every kernel's
    device time from torch.profiler beside its
    CUDA-event time (only the events of the kernel's own CUDA function,
    never more records than its wrappers' launches);
 2. artefacts of the JAX package: the committed k=11 SRS, a keygen of
    pose_enc that must reproduce the committed vk, the committed proof;
 3. pose_enc at k=11: keygen, two proofs from default_rng(0) that must be
    byte-identical and equal the JAX package's proof for the same SRS,
    circuit and seed (tests/data/torch_port_k11.npz), verify; then the
    base-16 MSM: its table, a keygen that must reproduce the committed vk and
    a proof that must equal the base-4 one;
 4. delay_enc at k=16, the headline: SRS setup, keygen (its vk equal to the
    JAX package's, tests/data/torch_port_vk_delay_enc_k16.npz, byte for
    byte, in base 4 and, after the base-16 proofs, base 16), create_proof,
    verify, with every kernel's launch count from this phase and from the
    proof alone, which must stay within the counts the redesigns reached;
    then one more proof under torch.profiler for the device time by kernel;
    then create_proof(ntt="mxu"): the four plans of the matmul NTT (seconds
    on the card), a K-b proof and a K11 proof in turn (walls, peak memory),
    the K11 proof equal to the K-b bytes, no K-b launch and the planned K11
    launches, one more under the profiler;
    then the base-16 MSM on the same SRS and keys: its table (seconds,
    launches, bytes), one proof that must equal the base-4 one, beside a
    base-4 proof's wall time, and one more under the profiler;
 5. mod_pow at k=17 (bench.py's draw): SRS setup, keygen (its vk equal to
    the JAX package's in both bases, as in phase 4), two proofs from
    default_rng(0) that must be byte-identical, verify, with its own launch
    counts a proof held to the same plan; then ntt="mxu" as in phase 4
    (n1 = n2 = 1024 on the 2^20 coset);
 6. delay_enc at k=18 (bench.py's draw, |T| = 31, 241,348 rows): SRS setup,
    a keygen that picks the split quotient (its vk equal to the JAX
    package's in both bases, as in phase 4), two split proofs from
    default_rng(0) that must be byte-identical and verify, their launch
    counts held to the split plan (8 launches of K6's coset form), one more
    under torch.profiler; then keygen(split=False), which must give the same
    vk, and one fused proof that must equal the split ones, with both peaks
    of device memory; ntt="mxu" on the split key must raise ValueError;
 7. (run after phase 4's base-4 proof, on its SRS and key) delay_enc k=16,
    B = 4 (four builds of phase 4's statement: a delay_enc circuit has one
    witness): create_proofs_batched twice from one rng seed (identical
    bytes, all verify, launches asserted: one K5, K6, open_eval and
    open_combine a batch, one pair_sel a commitment call), its peak device
    memory; create_proofs_pipelined two deep (seeds 1..4) against four
    serial proofs; the three walls and proofs a second; bench.py's own draw
    (four puzzles under the first one's key: only the first verifies); one
    batch under torch.profiler;
 8. the warm prover daemon (`python -m delay_enc_tpu_torch.runtime.daemon`,
    a subprocess whose stderr is kept in a file) in a fresh temporary
    directory: pose_enc:11 warmed with the commitment selfcheck (29 ok, no
    MISMATCH) and one request at selfcheck level 2 (the GWC checks ok);
    then delay_enc:16 and batch:16:4 warmed while a pose_enc:11 request is
    served, equal to the idle-served bytes; delay_enc:16 with 3 repeats in
    base 4 and base 16 (equal bytes); the batch of 4 with 2 repeats; shutdown
    and exit 0; then the daemon's SRS and key files read back here prove the
    served bytes, and keygen on that SRS gives the vk file's
    transcript_repr; warm, keygen, save_pk and load_pk seconds, the key
    file's bytes, the selfcheck's seconds, each request's best_s and spans,
    the batch's proofs a second and the daemon's peak device memory;
 9. (run after phase 7, on phase 4's SRS and key) the mesh of 4 shards: one
    a card with 4 cards or more (`make_mesh(4)`), else all on the one card
    (`Mesh.shared`), which runs every stage and kernel but no interconnect;
    the sharded NTT and iNTT of a k=16 column against the single-device
    K-b ntt and intt (launches asserted: a card and direction one
    shard_stages, one shard_reshuffle and one K-b call over its stack of
    shards, nothing else; host ms beside one device's K-b), the sharded MSM
    of the 2^16 SRS points against ops/msm.msm and the host's C MSM,
    batch_commit of 4 x 2^16 against serial commitments,
    create_proofs_batched(mesh=) of phase 7's builders and seed twice
    (phase 7's bytes, all verify; walls, proofs a second and peak memory
    beside phase 7's; one more under the profiler), the k=7 batch over 2
    shards in both bases against the JAX golden, and dryrun_multichip(4);
10. (run after phase 6, before phase 8) bench.py's largest rows, delay_enc
    k=19 (T_BITS 32) and mod_pow k=19 (T_BITS 33), nothing cut: SRS setup
    and keygen(k=19), which must pick the split quotient; two proofs from
    default_rng(0) that must be byte-identical and verify, their launches
    held to the split plan; one under torch.profiler; for
    delay_enc the base-16 table (seconds, K-d launches, bytes, peak), a
    msm="b16" proof with the base-4 bytes and its peak, and the table's
    copy into the card from pinned host memory (seconds);
the drawn statements are bench.py's (`runtime/workloads.py`); then the
kernels' JSON line (launches of phase 4's base-4 and base-16 runs, phase 6's
split run, phase 7's first batch, phase 8's daemon and reload, phase 9's
mesh and phase 10's split runs together; field_pow's those of phase 1's
field_pow path), the card's line, and the result line.  Any failure raises
and exits non-zero.
Without a CUDA device it exits non-zero before printing a result.
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
# the JAX package's vk of each row that phases 4, 5 and 6 key (written by the
# slow tests of tests/test_torch_vk_goldens.py), held byte for byte in both bases
VK_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_vk_{}_k{}.npz")
VK_GOLDENS = (("delay_enc", 16), ("mod_pow", 17), ("delay_enc", 18))
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
INT_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock
TC_INT8_PER_SM_CLK = 4096  # dense int8 tensor-core multiply-adds per SM per clock
WIDE = 2  # a 32x32->64 product counted as two integer multiply-adds
MONT_MULS = 128  # wide products in one 8-word CIOS Montgomery product
MONT_SQR_MULS = 36 + 64  # a squaring's: 8 diagonal and 28 cross products, then the reduction
ADD_MULS = 12  # Montgomery products in one complete addition
# checked in phase 1, launched by no proof, popped from the kernels line
# (K11's reduction runs inside its product)
OFF_PATH = ("field_sub", "field_add", "ntt_mxu_reduce")
# launched by no proof or batch (asserted): field_pow serves inv, mont_pow and
# batch_inv, which the prover never calls (it inverts its grand products' five
# totals on the host); it stays in the kernels line with its own path's launches
NOT_ON_PROOF = OFF_PATH + ("field_pow",)
FRACS_MULS = 40  # Montgomery products a row of K5 (csrc/fracs_row.cuh)
QUOTIENT_MULS = 116  # Montgomery products a row of K6 (csrc/quotient_row.cuh)
COMMIT_BATCHES = 6  # commitment batches a proof: 5, 8, 5, 1, 7 and 3 columns
SCAN_REPEATS = 50  # runs of each multi-tile scan and of K7 in phase 1, every result compared
OPEN_ROWS = (47, 6, 4)  # rows a delay_enc proof opens at x, omega x and omega^-1 x
BATCH = 4  # instances of phase 7's batch and of phase 1's batched kernels (bench.py's B)
MESH_SHARDS = 4  # phase 9's mesh: one shard a card, or four on the one card


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


# each CUDA function of csrc/ -> the port's wrappers (ops/_cuda.py kernels) that launch it
KERNEL_FUNCTIONS = {
    "field_binary_kernel": ("field_mont_mul", "field_add", "field_sub"),
    "field_pow_kernel": ("field_pow",), "field_wide_to_mont_kernel": ("field_wide_to_mont",),
    "ntt_fused_kernel": ("ntt_fused",), "scan_kernel": ("field_scan",),
    "quotient_kernel": ("quotient_h", "quotient_h_coset"), "fracs_kernel": ("gp_fracs",),
    "open_eval_kernel": ("open_eval",), "open_combine_kernel": ("open_combine",),
    "plane_sums_kernel": ("plane_sums",), "plane_sums16_kernel": ("plane_sums16",),
    "pair_sel_kernel": ("pair_sel",), "g1_add_kernel": ("g1_complete_add",),
    "fixed_base_kernel": ("g1_fixed_base_mul",), "shard_stages_kernel": ("shard_stages",),
    "shard_reshuffle_kernel": ("shard_reshuffle",),
    "mxu_split_kernel": ("ntt_mxu_split",), "mxu_product_kernel": ("ntt_mxu_product",),
    "mxu_reduce_kernel": ("ntt_mxu_reduce",),
}


def kernel_function(event_name: str) -> str:
    """A profiler event's CUDA function as its bare name: without return
    type, namespaces, template arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def device_ms(fn, reps: int, function: str, tries: int = 3):
    """The device time a call of fn spends in the CUDA function `function`
    (a key of KERNEL_FUNCTIONS), from torch.profiler over reps calls; None
    where the profiler saw none.  Only events whose function is that one
    count, against the launches of its wrappers alone; more records than
    launches raise (they would not be this call's).  The profiler can lose
    the last kernel records of a session (on an H100: 0 to 4 of 5 long
    launches, 18 of 20 short ones), so a call's time is the mean recorded
    launch times the launches a call made, from the best of `tries`
    sessions.  The CUDA-event time of the same calls is logged beside it:
    it holds the wrapper's host path as well, so the device time is the
    smaller, and far smaller only for short launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delay_enc_tpu_torch.ops import _cuda

    wrappers = KERNEL_FUNCTIONS[function]

    def launches() -> int:
        counts = _cuda.launch_counts()
        return sum(counts[w] for w in wrappers)

    fn()
    torch.cuda.synchronize()
    event_ms = timed(fn, reps)
    best = (0, 0.0, 0)
    for _ in range(tries):
        before = launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = launches() - before
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel_function(e.key) == function]
        recorded = sum(e.count for e in seen)
        if recorded > launched:
            raise AssertionError(f"device_ms {function}: {recorded} records of {launched} "
                                 f"launches")
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in seen)
        if recorded > best[0]:
            best = (recorded, us, launched)
        if recorded == launched:
            break
    recorded, us, launched = best
    dev_ms = us / 1e3 / recorded * launched / reps if recorded else None
    log(f"  device_ms {function}: {recorded} of {launched} launches recorded over {reps} calls, "
        f"{us / 1e3:.4f} ms; a call {ms_text(dev_ms)} on the device, {event_ms:.4f} ms by "
        f"CUDA events")
    return dev_ms


def sum_ms(times):
    """The sum of device times, None where one was not measured."""
    times = list(times)
    return None if None in times else sum(times)


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def device_note(dev_ms: float, event_ms: float, bound_ms: float) -> str:
    """The device time beside the CUDA-event time; a device time under the
    bound is marked: the repeated calls found their inputs in the 50 MB L2
    cache (the bytes bound counts device memory), the integer-rate model
    overcounts, or the profiler's records were miscounted."""
    flag = "; BELOW THE BOUND" if dev_ms < bound_ms else ""
    return (f" (device time {dev_ms:.4f} ms a call, torch.profiler, against {event_ms:.4f} ms "
            f"by CUDA events{flag})")


class Report:
    def __init__(self, int_rate: float, tc_rate: float):
        self.int_rate = int_rate  # integer multiply-adds per second
        self.tc_rate = tc_rate  # int8 tensor-core multiply-adds per second
        self.rows = {}

    def ops_ms(self, int_ops, tc_ops) -> float:
        """The operations' least time: integer units and tensor cores run
        side by side, so the longer of the two."""
        return max(int_ops / self.int_rate, tc_ops / self.tc_rate) * 1e3

    def add(self, name, *, err, ms, plain_ms, nbytes, int_ops, tc_ops=0, note="",
            device_ms=None, library_ms=None):
        from delay_enc_tpu_torch.ops import _cuda

        k = _cuda.KERNELS[name]
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = self.ops_ms(int_ops, tc_ops)
        self.rows[name] = {
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }
        if device_ms is not None:
            self.rows[name]["device_ms"] = device_ms
            note = f"{device_note(device_ms, ms, self.rows[name]['bound_ms'])}{note}"
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"phase 1 {name}: max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib}, bound {self.rows[name]['bound_ms']:.4f} ms "
              f"({self.rows[name]['bound_by']}){note}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    def also(self, name, shape, *, err, ms, int_ops, tc_ops=0, nbytes=0, note="",
             device_ms=None, library_ms=None):
        """One more shape of a kernel that has its row: printed, and kept
        under the row's `other_shapes`."""
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = self.ops_ms(int_ops, tc_ops)
        bound, by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
        other = {"shape": shape, "max_abs_err": err, "ms": ms, "bound_ms": bound, "bound_by": by}
        if device_ms is not None:
            other["device_ms"] = device_ms
            note = f"{device_note(device_ms, ms, bound)}{note}"
        if library_ms is not None:
            other["library_ms"] = library_ms
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        self.rows[name].setdefault("other_shapes", []).append(other)
        print(f"phase 1 {name} {shape}: max_abs_err={err} kernel {ms:.4f} ms{lib}, "
              f"bound {bound:.4f} ms ({by}){note}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")


def field_makers(dev, gen):
    """The operands of phase 1: (rand_field, carry_heavy), drawing from gen."""
    from delay_enc_tpu_torch.ops import limbs as L

    def rand_field(ctx, n):
        """n random reduced elements (Montgomery of random values) plus 0, 1, p-1."""
        w = torch.randint(-2**31, 2**31, (n, 8), generator=gen, device=dev, dtype=torch.int64)
        w = w.to(torch.int32)
        w[:, 7] &= 0x0FFFFFFF  # below 2^252 < p
        edge = L.to_device_mont(ctx, [0, 1, ctx.p - 1], dev)
        return torch.cat([w, edge])

    def carry_heavy(ctx):
        """Words that make every carry chain run long, each against each:
        p - 1, p - 2, R mod p, all-ones words under the top one, zero words."""
        ones = (1 << 256) - 1
        vals = [0, 1, ctx.p - 1, ctx.p - 2, (1 << 256) % ctx.p, (1 << 255) % ctx.p,
                ones >> 3, (ones >> 3) - 0xFFFFFFFF, (ones >> 3) ^ (0xFFFFFFFF << 96),
                0xFFFFFFFF << 64, 1 << 32, (1 << 224) + 1, 0xFFFFFFFF]
        if not all(0 <= v < ctx.p for v in vals):
            raise AssertionError("a carry-heavy operand is not reduced")
        w = L.to_tensor(L.ints_to_words_np(vals), dev)
        m = len(vals)
        return w.repeat_interleave(m, 0), w.repeat(m, 1)

    return rand_field, carry_heavy


def phase1(rep: Report, dev):
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import msm as M
    from delay_enc_tpu_torch.ops import msm_tree as MT
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.ops import poly as P
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.domain import Domain

    gen = torch.Generator(device=dev).manual_seed(1)
    rand_field, carry_heavy = field_makers(dev, gen)

    # K-a at 2^20 elements of Fr and Fq, elementwise and with a broadcast scalar
    n = 1 << 20
    for op, name in ((L.mont_mul, "field_mont_mul"), (L.add, "field_add"),
                     (L.sub, "field_sub")):
        plain = {L.mont_mul: L.mont_mul_plain, L.add: L.add_plain, L.sub: L.sub_plain}[op]
        err, ms, plain_ms = 0, 0.0, 0.0
        for ctx in (L.FR_CTX, L.FQ_CTX):
            ha, hb = carry_heavy(ctx)
            a = torch.cat([rand_field(ctx, n), ha])
            b = torch.cat([rand_field(ctx, n).flip(0), hb])
            for bb in (b, b[5:6], b[-2:-1]):
                got = op(ctx, a, bb)
                t0 = time.time()
                want = plain(ctx, a, bb)
                torch.cuda.synchronize()
                plain_ms += (time.time() - t0) * 1e3 / 6
                err = max(err, max_err(got, want))
            ms += timed(lambda: op(ctx, a, b), 20) / 2
        elems = a.shape[0]
        rep.add(name, err=err, ms=ms, plain_ms=plain_ms, nbytes=96 * elems,
                int_ops=elems * (MONT_MULS * WIDE if op is L.mont_mul else 0),
                device_ms=device_ms(lambda: op(ctx, a, b), 20, "field_binary_kernel"),
                note=f" (Fr and Fq, 2^20 + {elems - n} elements, carry-heavy pairs among them; "
                     f"device time over Fq)")

    # K-a again at (19, 2^19) elements, where the card and not the wrapper's
    # host path sets the time; a sample of the rows against the plain version
    big = rand_field(L.FR_CTX, 19 * (1 << 19) - 3).reshape(19, 1 << 19, 8)
    pick = torch.randint(0, 1 << 19, (4096,), generator=gen, device=dev)
    for op, plain, name in ((L.mont_mul, L.mont_mul_plain, "field_mont_mul"),
                            (L.add, L.add_plain, "field_add")):
        got = op(L.FR_CTX, big, big.flip(1))
        err = max_err(got[:, pick], plain(L.FR_CTX, big[:, pick], big.flip(1)[:, pick]))
        other = big.flip(1).contiguous()
        fn = lambda: op(L.FR_CTX, big, other)
        ms = timed(fn, 10)
        rep.also(name, "(19, 2^19) Fr", err=err, ms=ms, nbytes=96 * 19 * (1 << 19),
                 int_ops=19 * (1 << 19) * (MONT_MULS * WIDE if op is L.mont_mul else 0),
                 device_ms=device_ms(fn, 10, "field_binary_kernel"),
                 note=" (4096 columns of every row compared)")
        del got, other
    del big
    phase1_pow(rep, dev, rand_field, carry_heavy)

    # field_wide_to_mont at a k=18 proof's random polynomial, 2^18 rows of
    # 64 random bytes with all-zero and all-ones rows among them
    wide = torch.randint(-2**31, 2**31, (1 << 18, 16), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    wide[:5] = 0
    wide[5:10] = -1
    got = L.wide_to_mont(L.FR_CTX, wide)
    t0 = time.time()
    want = L.wide_to_mont_plain(L.FR_CTX, wide)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fn = lambda: L.wide_to_mont(L.FR_CTX, wide)
    rep.add("field_wide_to_mont", err=max_err(got, want), ms=timed(fn, 20), plain_ms=plain_ms,
            nbytes=96 * (1 << 18), int_ops=(1 << 18) * 2 * MONT_MULS * WIDE,
            device_ms=device_ms(fn, 20, "field_wide_to_mont_kernel"),
            note=" (Fr, 2^18 rows of 64 bytes: a k=18 proof's random polynomial)")
    del wide, got, want

    # K-b: (19, 2^19) forward coset transform, (6, 2^16) inverse
    d = Domain(16)
    plan, plan_ext = d.plan(dev), d.plan_ext(dev)
    ext_in = rand_field(L.FR_CTX, 19 * (1 << 19) - 3).reshape(19, 1 << 19, 8)
    inv_in = rand_field(L.FR_CTX, 6 * (1 << 16) - 3).reshape(6, 1 << 16, 8)

    def ntt_ops(batch, k):
        return batch * k * (1 << max(0, k - 1)) * MONT_MULS * WIDE

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
        ops += ntt_ops(b_, n_.bit_length() - 1)
        nbytes += 2 * x.numel() * 4 + (n_ // 2) * 32
    rep.add("ntt_fused", err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes, int_ops=ops,
            device_ms=sum_ms(device_ms(lambda: N.stockham(L.FR_CTX, x, tw), 3, "ntt_fused_kernel")
                             for x, tw in ((ext_in, plan_ext.tw), (inv_in, plan.tw_inv))),
            note=f" (whole transforms: (19, 2^19) forward + (6, 2^16) inverse; passes "
                 f"{[(p.s, p.c_log) for p in N.plan(19)]} and {[(p.s, p.c_log) for p in N.plan(16)]})")
    del ext_in

    # the fused sides, as the prover uses them: `_ext` (the zeta^i table in
    # the first load, rows read as zero-padded) against the plain pad, scale
    # and transform, every lane; `_coeff` (1/n in the last store); the
    # quotient's inverse at batch 1 with the zeta^-i / n table
    zeta = N.powers(L.FR_CTX, d.zeta, d.n_ext, dev)
    coeff = rand_field(L.FR_CTX, 19 * (1 << 16) - 3).reshape(19, 1 << 16, 8)
    padded = coeff.new_zeros(19, d.n_ext, 8)
    padded[:, : d.n] = coeff
    want = N.stockham_plain(L.FR_CTX, L.mont_mul_plain(L.FR_CTX, padded, zeta), plan_ext.tw)
    del padded
    err = max_err(K._ext(coeff, zeta, plan_ext), want)
    del want
    ms = timed(lambda: K._ext(coeff, zeta, plan_ext), 3)
    first = N.plan(19, 1 << 16)[0]
    rep.also("ntt_fused", "_ext: (19, 2^16) -> (19, 2^19), table and padding fused", err=err,
             ms=ms, int_ops=ntt_ops(19, 19) + 19 * (1 << 16) * MONT_MULS * WIDE,
             nbytes=coeff.numel() * 4 + 19 * d.n_ext * 32,
             note=f" (every lane; {first.nz} of {1 << first.s} local rows are not padding)")
    del coeff
    want = L.mont_mul_plain(L.FR_CTX, N.stockham_plain(L.FR_CTX, inv_in, plan.tw_inv), plan.n_inv)
    err = max_err(K._coeff(inv_in, plan), want)
    ms = timed(lambda: K._coeff(inv_in, plan), 5)
    rep.also("ntt_fused", "_coeff: (6, 2^16) inverse, 1/n in the last store", err=err, ms=ms,
             int_ops=ntt_ops(6, 16) + 6 * (1 << 16) * MONT_MULS * WIDE)
    del inv_in
    one_in = rand_field(L.FR_CTX, (1 << 19) - 3).reshape(1, 1 << 19, 8)
    want = L.mont_mul_plain(L.FR_CTX, N.stockham_plain(L.FR_CTX, one_in, plan_ext.tw_inv), zeta)
    err = max_err(N.stockham(L.FR_CTX, one_in, plan_ext.tw_inv, out_scale=zeta), want)
    ms = timed(lambda: N.stockham(L.FR_CTX, one_in, plan_ext.tw_inv, out_scale=zeta), 5)
    rep.also("ntt_fused", "(1, 2^19) inverse, a table in the last store", err=err, ms=ms,
             int_ops=ntt_ops(1, 19) + (1 << 19) * MONT_MULS * WIDE)
    del one_in, want, zeta
    # every small k, pose_enc's k (11 and 14), an odd k of two passes, each at
    # batch 1 and 3, with a short row and a constant at one of them
    for k in (0, 1, 2, 3, 4, 5, 11, 13, 14):
        tw = N.NTTPlan.make(L.FR_CTX, k, dev).tw
        err, ms = 0, 0.0
        for batch in (1, 3):
            count = batch << k
            x = rand_field(L.FR_CTX, max(0, count - 3))[-count:].reshape(batch, 1 << k, 8)
            err = max(err, max_err(N.stockham(L.FR_CTX, x, tw), N.stockham_plain(L.FR_CTX, x, tw)))
            ms = timed(lambda: N.stockham(L.FR_CTX, x, tw), 5)
        short = x[:, : max(1, (1 << k) - 3)].contiguous()
        got = N.stockham(L.FR_CTX, short, tw, n=1 << k, out_scale=x[0, 0])
        want = N.stockham_sides_plain(L.FR_CTX, short, tw, 1 << k, None, x[0, 0])
        err = max(err, max_err(got, want))
        rep.also("ntt_fused", f"k={k}, batch 1 and 3, and a short row with a constant", err=err,
                 ms=ms, int_ops=ntt_ops(3, k),
                 note=f" (passes {[(p.s, p.c_log) for p in N.plan(k)]})")

    # field_scan at (5, 2^16), the grand products' shape: the product scan for
    # the row, then every form; the plain version is the block scan over K-a
    x5 = rand_field(L.FR_CTX, 5 * (1 << 16) - 3).reshape(5, 1 << 16, 8)
    got = P.scan(L.FR_CTX, x5, "mul", "block")
    t0 = time.time()
    want = P.scan_plain(L.FR_CTX, x5, "mul", "block")
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fn = lambda: P.scan(L.FR_CTX, x5, "mul", "block")
    rep.add("field_scan", err=max_err(got, want), ms=timed(fn, 20), plain_ms=plain_ms,
            nbytes=2 * x5.numel() * 4, int_ops=5 * ((1 << 16) - 1) * MONT_MULS * WIDE,
            device_ms=device_ms(fn, 20, "scan_kernel"),
            note=f" (inclusive forward product over (5, 2^16), one launch, tiles of "
                 f"{P.kernel_plan(5, 1 << 16)[0]} threads x elements)")
    forms = [(op, ex, rv) for op in ("mul", "add") for ex in (False, True) for rv in (False, True)]

    def repeats(rows, n):
        """50 runs where a row is more than one tile: the look-back is a race."""
        threads, items = P.kernel_plan(rows, n)[0]
        return SCAN_REPEATS if n > threads * items else 1

    def scan_err(x):
        err = 0
        for op, ex, rv in forms:
            want = P.scan_plain(L.FR_CTX, x, op, "hs", exclusive=ex, reverse=rv)
            for _ in range(repeats(x.shape[0], x.shape[1])):
                err = max(err, max_err(P.scan(L.FR_CTX, x, op, "block", exclusive=ex, reverse=rv),
                                       want))
        return err

    ha, hb = carry_heavy(L.FR_CTX)
    holed = x5[:3, :5000].clone()  # five tiles a row, a zero in the first, a middle, the last
    holed[0, 500] = 0
    holed[1, 0] = 0
    holed[1, 2100] = 0
    holed[2, 4999] = 0
    row20 = rand_field(L.FR_CTX, (1 << 20) - 3).reshape(1, 1 << 20, 8)
    for x, shape in ((x5, "(5, 2^16)"), (x5.reshape(1, -1, 8)[:, : (1 << 16) + 1], "(1, 2^16 + 1)"),
                     (x5[:3, :1], "(3, 1)"), (x5[:3, :2], "(3, 2)"), (x5[:3, :1000], "(3, 1000)"),
                     (holed, "(3, 5000) with zeros inside"),
                     (torch.stack([ha, hb]), f"(2, {ha.shape[0]}) carry-heavy operands"),
                     (row20, "(1, 2^20)")):
        x = x.contiguous()
        fn = lambda: P.scan(L.FR_CTX, x, "mul", "block", exclusive=True, reverse=True)
        n_ = x.shape[1]
        runs = repeats(x.shape[0], n_)
        rep.also("field_scan", f"{shape}, 8 forms (mul and add, inclusive and exclusive, "
                 f"forward and reverse)", err=scan_err(x), ms=timed(fn, 10), nbytes=2 * x.numel() * 4,
                 int_ops=x.shape[0] * (n_ - 1) * MONT_MULS * WIDE,
                 note=f" (time of the exclusive reverse product; device time "
                      f"{ms_text(device_ms(fn, 10, 'scan_kernel'))}; tiles of "
                      f"{P.kernel_plan(x.shape[0], n_)[0]}; each form {runs} times, every result "
                      f"compared)")
    for count in (1, 2, 1000, 1 << 16, (1 << 16) + 1, 1 << 20):
        x = x5[1, 3].contiguous()
        want = P.powers_of_plain(L.FR_CTX, x, count)
        err = max(max_err(P.powers_of(L.FR_CTX, x, count), want)
                  for _ in range(repeats(1, count)))
        fn = lambda: P.powers_of(L.FR_CTX, x, count)
        rep.also("field_scan", f"{count} powers of one element (constant input)", err=err,
                 ms=timed(fn, 10), nbytes=32 * count,
                 int_ops=max(0, count - 1) * MONT_MULS * WIDE,
                 note=f" (device time {ms_text(device_ms(fn, 10, 'scan_kernel'))})")
    # the prover's opening powers: the points (3, n), the inverse points
    # (3, n + 1) and v (1, the tallest stack), one launch each
    for rows, count in ((3, 1 << 16), (3, (1 << 16) + 1), (1, 47)):
        xs = x5[:rows, 7].contiguous()
        want = torch.stack([P.powers_of_plain(L.FR_CTX, x, count) for x in xs])
        err = max(max_err(P.powers_rows(L.FR_CTX, xs, count), want)
                  for _ in range(repeats(rows, count)))
        fn = lambda: P.powers_rows(L.FR_CTX, xs, count)
        rep.also("field_scan", f"({rows}, {count}) powers, one element a row (powers_rows)",
                 err=err, ms=timed(fn, 10), nbytes=32 * rows * count,
                 int_ops=rows * max(0, count - 1) * MONT_MULS * WIDE,
                 note=f" (device time {ms_text(device_ms(fn, 10, 'scan_kernel'))}; each "
                      f"{repeats(rows, count)} times, every result compared)")
    del x5, holed, row20

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
            int_ops=npts * ADD_MULS * MONT_MULS * WIDE, note=" (2^16 pairs)",
            device_ms=device_ms(lambda: M.complete_add(p, q), 20, "g1_add_kernel"))
    # and at 2^20 pairs, where the card and not the host's launch path sets the time
    p20, q20 = p.repeat(16, 1, 1), q.repeat(16, 1, 1)
    err = max_err(M.complete_add(p20, q20)[-npts:], want)
    ms = timed(lambda: M.complete_add(p20, q20), 10)
    rep.also("g1_complete_add", "2^20 pairs", err=err, ms=ms, nbytes=3 * 96 * 16 * npts,
             int_ops=16 * npts * ADD_MULS * MONT_MULS * WIDE,
             device_ms=device_ms(lambda: M.complete_add(p20, q20), 10, "g1_add_kernel"))
    del p20, q20

    # fixed base: 2^10 scalars with 0, 1, r - 1 and a power of two against the
    # plain version, then 2^16 random ones, all compared as affine points
    from delay_enc_tpu_torch.fields import FR

    table_g = M.base_table((1, 2), dev)
    w = 1 << 15

    def rand_scalars(count):
        return torch.randint(0, 2**31, (count, 8), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32) & 0x0FFFFFFF

    special = M.scalars_to_words([0, 1, FR.p - 1, 1 << 200, (1 << 253) + 1, FR.p - 2], dev)
    small = torch.cat([special, rand_scalars(1024 - special.shape[0])])
    err = int(np.abs(affine_words(M.fixed_base_batch_mul(table_g, small))
                     - affine_words(M.fixed_base_batch_mul_plain(table_g, small))).max())
    scal = rand_scalars(2 * w)
    pts = M.fixed_base_batch_mul(table_g, scal)
    t0 = time.time()
    want = M.fixed_base_batch_mul_plain(table_g, scal)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max(err, int(np.abs(affine_words(pts) - affine_words(want)).max()))
    del want
    ms = timed(lambda: M.fixed_base_batch_mul(table_g, scal), 5)
    npts = 2 * w
    rep.add("g1_fixed_base_mul", err=err, ms=ms, plain_ms=plain_ms,
            nbytes=npts * (32 + 96) + M.SCALAR_BITS * 96,
            int_ops=npts * M.SCALAR_BITS * ADD_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: M.fixed_base_batch_mul(table_g, scal), 3,
                                "fixed_base_kernel"),
            note=f" (2^16 scalars, {M.fixed_base_split(npts)} threads a scalar; 2^10 with "
                 f"0, 1, r - 1 and powers of two also agree; compared affine)")

    # K-c: selector mode, C = 16 rows of W = 2^15 lanes over a pair table
    table = M.pair_tables(pts)

    def rand_sel(rows, width):
        return torch.randint(0, 16, (rows, width), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.uint8)

    def affine_err(got, want):
        return int(np.abs(affine_words(got) - affine_words(want)).max())

    sel = rand_sel(16, w)
    got = MT.tree_reduce(table, sel)
    t0 = time.time()
    want = MT.tree_reduce_plain(table, sel)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = affine_err(got, want)
    ms = timed(lambda: MT.tree_reduce(table, sel), 5)
    rep.add("plane_sums", err=err, ms=ms, plain_ms=plain_ms,
            nbytes=16 * w + 16 * w * 96 + 16 * 96,
            int_ops=16 * (w - 1) * ADD_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: MT.tree_reduce(table, sel), 5, "plane_sums_kernel"),
            note=" (selector mode, C=16, W=2^15, compared affine)")

    # K-c alone at the proof's shapes: one column and the largest batch; the
    # plain version sums a sample of the rows (first, last and random ones)
    rng = np.random.default_rng(2)
    for cols in (1, 8):
        rows = cols * M.PLANES
        sel = rand_sel(rows, w)
        got = MT.tree_reduce(table, sel)
        pick = sorted({0, rows - 1, *rng.integers(0, rows, 14).tolist()})
        err = affine_err(got[pick], MT.tree_reduce_plain(table, sel[pick]))
        ms = timed(lambda: MT.tree_reduce(table, sel), 5)
        rep.also("plane_sums", f"rows={rows} ({cols} x 127), W=2^15", err=err, ms=ms,
                 int_ops=rows * (w - 1) * ADD_MULS * MONT_MULS * WIDE,
                 note=f" ({len(pick)} rows compared affine; passes "
                      f"{[(p.run, p.threads, p.chunks) for p in MT.plan(rows, w)]})")
    # a width that is no multiple of a run or of 32, one lane, one row, and
    # rows of plain points without selectors
    for rows, width in ((3, 8191 + 6), (5, 1), (1, w)):
        sel = rand_sel(rows, width)
        sub = table[:, :width].contiguous()
        err = affine_err(MT.tree_reduce(sub, sel), MT.tree_reduce_plain(sub, sel))
        ms = timed(lambda: MT.tree_reduce(sub, sel), 3)
        rep.also("plane_sums", f"rows={rows}, W={width}", err=err, ms=ms,
                 int_ops=rows * (width - 1) * ADD_MULS * MONT_MULS * WIDE)
    direct = table[1:4, :1000 + 7].contiguous()
    err = affine_err(MT.tree_reduce(direct), MT.tree_reduce_plain(direct))
    ms = timed(lambda: MT.tree_reduce(direct), 3)
    rep.also("plane_sums", "rows=3, W=1007, points without selectors", err=err, ms=ms,
             int_ops=3 * 1006 * ADD_MULS * MONT_MULS * WIDE)
    del table
    phase1_b16(rep, dev, gen, pts, affine_err)
    del pts
    phase1_fused(rep, dev, rand_field, carry_heavy)
    phase1_split(rep, dev, rand_field, carry_heavy)
    phase1_open(rep, dev, rand_field, carry_heavy)
    phase1_batch(rep, dev, rand_field, carry_heavy)
    phase1_shard(rep, dev, rand_field, carry_heavy)
    phase1_mxu(rep, dev, rand_field, carry_heavy)


def pow_ops(e: int, elems: int) -> int:
    """Integer multiply-adds of a^e over `elems` elements by MSB-first
    square-and-multiply: a squaring for every bit below the top one and a
    product for every set one below it."""
    if e == 0:
        return 0
    squarings, products = e.bit_length() - 1, bin(e).count("1") - 1
    return (squarings * MONT_SQR_MULS + products * MONT_MULS) * WIDE * elems


def phase1_pow(rep: Report, dev, rand_field, carry_heavy):
    """field_pow against mont_pow_plain on the card, bit-exact: Fr and Fq at
    2^16 elements with 0, 1, p - 1, R mod p and the carry-heavy words among
    them, to the exponents p - 2 (inv), 0, 1, 3 and a random 256-bit one;
    inv and mont_pow one field_pow launch each and no K-a (asserted); the
    inversion's device time beside its bound; batch_inv at 2^16 with zeros
    inside, a sample of its rows against the plain inverse on the CPU."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L

    n = 1 << 16
    e_rand = int.from_bytes(np.random.default_rng(17).bytes(32), "little")
    rows = {}
    for ctx, name in ((L.FR_CTX, "Fr"), (L.FQ_CTX, "Fq")):
        heavy = carry_heavy(ctx)[1][:13]  # the 13 values, R mod p among them
        a = torch.cat([rand_field(ctx, n - 16), heavy])
        err, plain_ms = 0, 0.0
        for e in (ctx.p - 2, 0, 1, 3, e_rand):
            _cuda.reset_launches()
            got = L.inv(ctx, a) if e == ctx.p - 2 else L.mont_pow(ctx, a, e)
            counts = {k: v for k, v in _cuda.launch_counts().items() if v}
            if counts != {"field_pow": 1}:
                raise AssertionError(f"mont_pow to a {e.bit_length()}-bit exponent launched "
                                     f"{counts}, not one field_pow")
            torch.cuda.synchronize()
            t0 = time.time()
            want = L.mont_pow_plain(ctx, a, e)
            torch.cuda.synchronize()
            if e == ctx.p - 2:
                plain_ms = (time.time() - t0) * 1e3
            err = max(err, max_err(got, want))
        for e, what in ((ctx.p - 2, "inverse"), (e_rand, "random 256-bit exponent")):
            fn = lambda: L.mont_pow(ctx, a, e)  # noqa: E731
            rows[(name, what)] = dict(err=err, ms=timed(fn, 20), plain_ms=plain_ms,
                                      int_ops=pow_ops(e, n), nbytes=64 * n,
                                      device_ms=device_ms(fn, 20, "field_pow_kernel"))
    fr = rows[("Fr", "inverse")]
    rep.add("field_pow", **fr, note=" (Fr inverse a^(p-2) of 2^16 elements, 0, 1, p - 1, "
            "R mod p and carry-heavy words among them; the exponents p - 2, 0, 1, 3 and a "
            "random 256-bit one in Fr and Fq, each one launch, equal to mont_pow_plain; "
            "plain: the inverse's loop of mont_mul_plain on the card)")
    for (name, what), row in rows.items():
        if (name, what) != ("Fr", "inverse"):
            rep.also("field_pow", f"{name} {what}, 2^16 elements", err=row["err"], ms=row["ms"],
                     int_ops=row["int_ops"], nbytes=row["nbytes"], device_ms=row["device_ms"])

    # batch_inv: the scans, one field_pow on the total and two K-a products;
    # inverses are unique, so a sample of rows against the plain inverse on the CPU
    ctx = L.FR_CTX
    x = rand_field(ctx, n - 3)
    zeros = torch.tensor([5, 1000, 40000, n - 1], device=dev)
    x[zeros] = 0
    _cuda.reset_launches()
    got = L.batch_inv(ctx, x)
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    if counts != {"field_pow": 1, "field_scan": 2, "field_mont_mul": 2}:
        raise AssertionError(f"batch_inv launched {counts}")
    pick = torch.cat([zeros, torch.randperm(n, device=dev)[:2044]])
    want = L.mont_pow_plain(ctx, x[pick].cpu(), ctx.p - 2)
    err = max(max_err(got[pick].cpu(), want), max_err(got, L.inv(ctx, x)))
    ms = timed(lambda: L.batch_inv(ctx, x), 20)
    print(f"phase 1 batch_inv (2^16) Fr, zeros at {zeros.tolist()}: max_abs_err={err} "
          f"{ms:.4f} ms a call by CUDA events; launches {json.dumps(counts)}; 2048 rows against "
          f"the CPU plain inverse, every row against inv", flush=True)
    if err != 0:
        raise AssertionError("batch_inv disagrees with the plain inverse")


def field_pow_path(dev) -> dict:
    """The slice's own path of field_pow, its entry points at 2^16 Fr
    elements on the card: inv, mont_pow, batch_inv and batch_inv_log, with
    the launch counts set to 0 just before and read just after (one
    field_pow a call; two field_scan and two K-a products in each batch
    inversion).  No proof takes it.  Returns the field_pow launches only:
    the kernels line's K-a and field_scan rows count proofs' launches."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import poly as P

    ctx = L.FR_CTX
    x = L.to_tensor(ctx.to_mont_np([(7 * i + 3) % 1009 for i in range(1 << 16)]), dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    a_inv = L.inv(ctx, x)
    cube = L.mont_pow(ctx, x, 3)
    b_inv = L.batch_inv(ctx, x)
    b_log = P.batch_inv_log(ctx, x)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    if got != {"field_pow": 4, "field_scan": 4, "field_mont_mul": 4}:
        raise AssertionError(f"the field_pow path launched {got}")
    if not (torch.equal(a_inv, b_inv) and torch.equal(b_inv, b_log)):
        raise AssertionError("inv, batch_inv and batch_inv_log differ")
    if not torch.equal(L.mont_mul(ctx, L.mont_mul(ctx, a_inv, a_inv), cube)[x.any(-1)],
                       x[x.any(-1)]):
        raise AssertionError("x^-2 x^3 is not x")
    print(f"phase 1 field_pow path: inv, mont_pow(3), batch_inv and batch_inv_log of 2^16 Fr "
          f"elements on the card agree (zeros to zero); launches {json.dumps(got)}", flush=True)
    return {"field_pow": got["field_pow"]}


def phase1_b16(rep: Report, dev, gen, pts, affine_err):
    """plane_sums16 over the base-16 table of the 2^16 points of phase 1, and
    the selector kernel, against their plain versions."""
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.ops import msm as M
    from delay_enc_tpu_torch.ops import msm16 as M16
    from delay_enc_tpu_torch.ops import msm_tree as MT

    table = M16.pair_tables16(pts)  # (256, 2^15, 3, 8)
    w = table.shape[1]

    def rand_sel(rows, width):
        return torch.randint(0, 256, (rows, width), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.uint8)

    # C = 16 rows: row 0 runs through all 256 options, row 1 takes the
    # identity option everywhere, row 2 option 255
    sel = rand_sel(16, w)
    sel[0] = torch.arange(256, device=dev, dtype=torch.int64).to(torch.uint8).repeat(w // 256)
    sel[1] = 0
    sel[2] = 255
    got = MT.tree_reduce(table, sel)
    t0 = time.time()
    want = MT.tree_reduce_plain(table, sel)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = affine_err(got, want)
    if M.points_from_device(got[1:2]) != [None]:
        raise AssertionError("a row of identity options does not sum to the identity")
    ms = timed(lambda: MT.tree_reduce(table, sel), 5)
    rep.add("plane_sums16", err=err, ms=ms, plain_ms=plain_ms,
            nbytes=16 * w + 16 * w * 96 + 16 * 96,
            int_ops=16 * (w - 1) * ADD_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: MT.tree_reduce(table, sel), 5, "plane_sums16_kernel"),
            note=" (256-option table, C=16, W=2^15, every selector value, the identity "
                 "option and 255 among the rows; compared affine)")
    # the proof's shapes, one column and the largest batch of 64 planes each;
    # the plain version sums a sample of the rows
    rng = np.random.default_rng(4)
    for cols in (1, 8):
        rows = cols * M16.PLANES
        sel = rand_sel(rows, w)
        sel[0] = 0
        sel[-1] = 255
        got = MT.tree_reduce(table, sel)
        pick = sorted({0, rows - 1, *rng.integers(0, rows, 14).tolist()})
        err = affine_err(got[pick], MT.tree_reduce_plain(table, sel[pick]))
        ms = timed(lambda: MT.tree_reduce(table, sel), 5)
        rep.also("plane_sums16", f"rows={rows} ({cols} x 64), W=2^15", err=err, ms=ms,
                 nbytes=rows * w + table.numel() * 4 + rows * 96,
                 int_ops=rows * (w - 1) * ADD_MULS * MONT_MULS * WIDE,
                 note=f" ({len(pick)} rows compared affine; passes "
                      f"{[(p.run, p.threads, p.chunks) for p in MT.plan(rows, w)]})")
    for rows, width in ((3, 8191 + 6), (5, 1), (1, w)):
        sel = rand_sel(rows, width)
        sub = table[:, :width].contiguous()
        err = affine_err(MT.tree_reduce(sub, sel), MT.tree_reduce_plain(sub, sel))
        ms = timed(lambda: MT.tree_reduce(sub, sel), 3)
        rep.also("plane_sums16", f"rows={rows}, W={width}", err=err, ms=ms,
                 int_ops=rows * (width - 1) * ADD_MULS * MONT_MULS * WIDE)
    del table, sub

    # selectors: B = 8 and 1 columns of 2^16 scalars, random below 2^253,
    # with 0, 1, r - 1 and 2^253 at even and odd places of the first and
    # last column; at 2 bits (base 4) and 4 bits (base 16) a digit
    n = 1 << 16
    special = M.scalars_to_words([0, 1, FR.p - 1, 1 << 253, FR.p - 1, 0, 1 << 253], dev)
    words = torch.randint(-2**31, 2**31, (8, n, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    words[..., 7] &= 0x1FFFFFFF
    words[0, : special.shape[0]] = special
    words[-1, -special.shape[0]:] = special
    for batch in (8, 1):
        x = words[:batch].contiguous()
        for bits in (2, 4):
            planes = M.sel_planes(bits)
            got = M.pair_sel(x, bits)
            t0 = time.time()
            want = M.pair_sel_plain(x, bits)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            err = max_err(got, want)
            fn = lambda: M.pair_sel(x, bits)
            ms, dev_ms = timed(fn, 20), device_ms(fn, 20, "pair_sel_kernel")
            nbytes = batch * n * 32 + batch * planes * n // 2
            what = f"B={batch}, n=2^16, {bits}-bit digits ({planes} planes)"
            if (batch, bits) == (8, 2):
                rep.add("pair_sel", err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes, int_ops=0,
                        device_ms=dev_ms,
                        note=f" ({what}: the base-4 path's largest batch; 0, 1, r - 1, 2^253 "
                             f"among the scalars)")
            else:
                rep.also("pair_sel", what, err=err, ms=ms, nbytes=nbytes, int_ops=0,
                         device_ms=dev_ms, note=f" (plain {plain_ms:.4f} ms)")


def phase1_fused(rep: Report, dev, rand_field, carry_heavy):
    """K5 and K6 at the main path's shapes against their plain versions on
    the card (the compositions over K-a), and at small sizes, with
    carry-heavy words among the operands, against the plain versions on the
    CPU."""
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

    rng = np.random.default_rng(3)
    consts = K.challenge_words(*(int(v) for v in rng.integers(1, 2**62, 4)),
                               [int(v) for v in rng.integers(1, 2**62, 6)])
    heavy_a, heavy_b = carry_heavy(L.FR_CTX)
    heavy = torch.cat([heavy_a, heavy_b])

    def stack(rows, n, with_heavy=False):
        w = rand_field(L.FR_CTX, rows * n - 3).reshape(rows, n, 8)
        if with_heavy:  # carry-heavy words scattered over every column
            flat = w.reshape(-1, 8)
            at = torch.randperm(flat.shape[0], device=dev)[: heavy.shape[0]]
            flat[at] = heavy[: at.shape[0]]
        return w

    def cpu(ts):
        return [t.cpu() for t in ts]

    # K5 at delay_enc k=16: 2^16 rows, 7 of them inactive
    n = 1 << 16
    fr_in = [stack(6, n), stack(6, n), stack(1, n)[0], stack(len(ALL_FIXED), n), stack(8, n)]
    usable = n - 7
    got = K.gp_fracs(*fr_in, consts, usable)
    t0 = time.time()
    want = K.gp_fracs_plain(*fr_in, consts, usable)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max(max_err(g, w) for g, w in zip(got, want))
    ms = timed(lambda: K.gp_fracs(*fr_in, consts, usable), 20)
    # read: 6 + 6 + 1 columns, 6 key rows (tags, table), 8 lookup columns; write 10
    rep.add("gp_fracs", err=err, ms=ms, plain_ms=plain_ms, nbytes=(27 + 10) * n * 32,
            int_ops=usable * FRACS_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: K.gp_fracs(*fr_in, consts, usable), 20, "fracs_kernel"),
            note=f" (2^16 rows, {n - usable} inactive; plain: the composition over K-a)")
    del fr_in, got, want
    for n_small, usable in ((1000, 993), (8, 1)):
        small = [stack(6, n_small, True), stack(6, n_small, True), stack(1, n_small, True)[0],
                 stack(len(ALL_FIXED), n_small, True), stack(8, n_small, True)]
        got = K.gp_fracs(*small, consts, usable)
        want = K.gp_fracs(*cpu(small), consts, usable)
        err = max(max_err(g.cpu(), w) for g, w in zip(got, want))
        ms = timed(lambda: K.gp_fracs(*small, consts, usable), 10)
        rep.also("gp_fracs", f"{n_small} rows, {usable} active, carry-heavy words, "
                 f"against the CPU plain version", err=err, ms=ms,
                 nbytes=37 * n_small * 32, int_ops=usable * FRACS_MULS * MONT_MULS * WIDE)

    # K6 at delay_enc k=16: the extended coset of 2^19 rows
    n_ext = 1 << 19
    q_in = [stack(K.WIT_ROWS, n_ext), stack(len(KEY_ROWS), n_ext), stack(1, n_ext)[0],
            stack(1, 8)[0]]
    got = K.quotient_h(*q_in, consts)
    t0 = time.time()
    want = K.quotient_h_plain(*q_in, consts)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_err(got, want)
    del want
    ms = timed(lambda: K.quotient_h(*q_in, consts), 5)
    # read: 19 witness and 24 key columns and X; write h
    rep.add("quotient_h", err=err, ms=ms, plain_ms=plain_ms, nbytes=(44 + 1) * n_ext * 32,
            int_ops=n_ext * QUOTIENT_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: K.quotient_h(*q_in, consts), 5, "quotient_kernel"),
            note=" (2^19 rows; plain: the composition over K-a with its stack and roll copies)")
    del q_in, got
    for n_small in (1 << 9, 8):
        small = [stack(K.WIT_ROWS, n_small, True), stack(len(KEY_ROWS), n_small, True),
                 stack(1, n_small, True)[0], heavy[:8].contiguous()]
        got = K.quotient_h(*small, consts)
        err = max_err(got.cpu(), K.quotient_h(*cpu(small), consts))
        ms = timed(lambda: K.quotient_h(*small, consts), 10)
        rep.also("quotient_h", f"{n_small} rows, carry-heavy words, against the CPU plain "
                 f"version", err=err, ms=ms, nbytes=45 * n_small * 32,
                 int_ops=n_small * QUOTIENT_MULS * MONT_MULS * WIDE)


def phase1_split(rep: Report, dev, rand_field, carry_heavy):
    """K9's forms at delay_enc k=18 (n = 2^18): K6's coset form (rot 1, one
    value of 1/Z_H, rows stored at stride 8 and offset j of a 2^21 h_ext) at
    cosets 0 and 7 against its plain version on the card, the places it does
    not own left as they were, and at small sizes with carry-heavy words
    against the plain version on the CPU; the fused form again at rot 8 and
    stride 1; K-b over the 43 stacked rows with a coset's power table in its
    first load, and the 2^21 inverse with the unscale table in its last
    store, against the plain transform on a sample of rows."""
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.domain import MAX_DEGREE, Domain
    from delay_enc_tpu_torch.plonk.keygen import KEY_ROWS, coset_tables

    rng = np.random.default_rng(5)
    consts = K.challenge_words(*(int(v) for v in rng.integers(1, 2**62, 4)),
                               [int(v) for v in rng.integers(1, 2**62, 6)])
    heavy_a, heavy_b = carry_heavy(L.FR_CTX)
    heavy = torch.cat([heavy_a, heavy_b])
    d = Domain(18)
    n, rows = d.n, K.WIT_ROWS + len(KEY_ROWS)

    def stack(count, length, with_heavy=False):
        w = rand_field(L.FR_CTX, count * length - 3).reshape(count, length, 8)
        if with_heavy:
            flat = w.reshape(-1, 8)
            at = torch.randperm(flat.shape[0], device=dev)[: heavy.shape[0]]
            flat[at] = heavy[: at.shape[0]]
        return w

    def sentinel(length):
        return torch.full((length, 8), -1, dtype=torch.int32, device=dev)

    # K6's coset form: cosets 0 and 7 of one h_ext, against the plain version
    # (the composition over K-a) storing into its own
    ev = stack(rows, n, True)
    x, zh = stack(1, n)[0], stack(1, 8)[0, 5:6].contiguous()
    coset = lambda j, out: K.quotient_h(ev[: K.WIT_ROWS], ev[K.WIT_ROWS:], x, zh, consts,
                                        rot=1, out=out, out_stride=MAX_DEGREE, out_offset=j)
    got, want = sentinel(MAX_DEGREE * n), sentinel(MAX_DEGREE * n)
    t0 = time.time()
    for j in (0, 7):
        K.quotient_h_plain(ev[: K.WIT_ROWS], ev[K.WIT_ROWS:], x, zh, consts, rot=1, out=want,
                           out_stride=MAX_DEGREE, out_offset=j)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3 / 2
    for j in (0, 7):
        coset(j, got)
    err = max_err(got, want)
    untouched = got.reshape(n, MAX_DEGREE, 8)[:, 1:7]
    if not bool((untouched == -1).all()):
        raise AssertionError("the coset form stored outside its places")
    ms = timed(lambda: coset(7, got), 5)
    rep.add("quotient_h_coset", err=err, ms=ms, plain_ms=plain_ms,
            nbytes=(44 + 1) * n * 32, int_ops=n * QUOTIENT_MULS * MONT_MULS * WIDE,
            device_ms=device_ms(lambda: coset(7, got), 5, "quotient_kernel"),
            note=" (2^18 rows of one coset, rot 1, stored at 8i + j of a 2^21 h_ext, cosets 0 "
                 "and 7, carry-heavy words among the operands, the places of cosets 1-6 left "
                 "as they were; plain: the composition over K-a)")
    for n_small in (1 << 9, 8):
        small = [stack(K.WIT_ROWS, n_small, True), stack(len(KEY_ROWS), n_small, True),
                 stack(1, n_small, True)[0], heavy[3:4].contiguous()]
        cpu = [t.cpu() for t in small]
        err = 0
        for j in (0, 7):
            out = sentinel(MAX_DEGREE * n_small)
            K.quotient_h(*small, consts, rot=1, out=out, out_stride=MAX_DEGREE, out_offset=j)
            want = K.quotient_h(*cpu, consts, rot=1, out=sentinel(MAX_DEGREE * n_small).cpu(),
                                out_stride=MAX_DEGREE, out_offset=j)
            err = max(err, max_err(out.cpu(), want))
        ms = timed(lambda: K.quotient_h(*small, consts, rot=1, out=out, out_stride=MAX_DEGREE,
                                        out_offset=7), 10)
        rep.also("quotient_h_coset", f"{n_small} rows, cosets 0 and 7, carry-heavy words, "
                 f"against the CPU plain version", err=err, ms=ms, nbytes=45 * n_small * 32,
                 int_ops=n_small * QUOTIENT_MULS * MONT_MULS * WIDE)
    # the fused form on the same words, now that rot and the store are arguments
    n_f = 1 << 12
    fused = [ev[: K.WIT_ROWS, :n_f].contiguous(), ev[K.WIT_ROWS:, :n_f].contiguous(),
             x[:n_f].contiguous(), stack(1, MAX_DEGREE)[0]]
    err = max_err(K.quotient_h(*fused, consts), K.quotient_h_plain(*fused, consts))
    rep.also("quotient_h", "2^12 rows, rot 8, stride 1, after the coset form's launches",
             err=err, ms=timed(lambda: K.quotient_h(*fused, consts), 10),
             int_ops=n_f * QUOTIENT_MULS * MONT_MULS * WIDE)
    del ev, got, want, fused

    def ntt_ops(batch, k):
        return batch * k * (1 << max(0, k - 1)) * MONT_MULS * WIDE

    # K-b: the coset evaluations of 43 coefficient rows (coset 7's powers in
    # the first load), a sample of the rows against the plain transform
    plan, plan_ext = d.plan(dev), d.plan_ext(dev)
    pows = coset_tables(d, dev)[0][7].contiguous()
    coeff = stack(rows, n, True)
    got = N.stockham(L.FR_CTX, coeff, plan.tw, in_table=pows)
    pick = sorted({0, K.WIT_ROWS - 1, K.WIT_ROWS, rows - 1, *rng.integers(0, rows, 4).tolist()})
    t0 = time.time()
    want = N.stockham_sides_plain(L.FR_CTX, coeff[pick], plan.tw, n, pows, None)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_err(got[pick], want)
    ms = timed(lambda: N.stockham(L.FR_CTX, coeff, plan.tw, in_table=pows), 3)
    rep.also("ntt_fused", f"(43, 2^18) with a coset's power table in the first load "
             f"(_jit_coset_evals)", err=err, ms=ms,
             int_ops=ntt_ops(rows, 18) + rows * n * MONT_MULS * WIDE,
             nbytes=2 * coeff.numel() * 4 + n * 32 + (n // 2) * 32,
             note=f" (rows {pick} compared, plain {plain_ms:.1f} ms for them; passes "
                  f"{[(p.s, p.c_log) for p in N.plan(18)]})")
    del coeff, got, want
    # the interleaved inverse of length 2^21 with zeta^-i / n_ext in its last store
    unscale = N.powers(L.FR_CTX, FR.inv(d.zeta), d.n_ext, dev, start=FR.inv(d.n_ext))
    h_ext = stack(1, d.n_ext, True)[0]
    got = N.stockham(L.FR_CTX, h_ext, plan_ext.tw_inv, out_scale=unscale)
    want = N.stockham_sides_plain(L.FR_CTX, h_ext, plan_ext.tw_inv, d.n_ext, None, unscale)
    ms = timed(lambda: N.stockham(L.FR_CTX, h_ext, plan_ext.tw_inv, out_scale=unscale), 5)
    rep.also("ntt_fused", "(1, 2^21) inverse, zeta^-i / n_ext in the last store "
             "(_jit_interleave_intt)", err=max_err(got, want), ms=ms,
             int_ops=ntt_ops(1, 21) + d.n_ext * MONT_MULS * WIDE,
             nbytes=3 * d.n_ext * 32 + (d.n_ext // 2) * 32,
             note=f" (every element compared; passes {[(p.s, p.c_log) for p in N.plan(21)]})")


def phase1_open(rep: Report, dev, rand_field, carry_heavy):
    """K7 at the delay_enc k=16 openings (47, 6 and 4 rows of 2^16, carry-
    heavy words among them) against its plain version on the card, 50 times
    over (the eval's last-block ticket is a race between blocks); at ragged
    lengths, one and several eval blocks a row, against the plain version on
    the CPU."""
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.plonk import kernels as K

    heavy_a, heavy_b = carry_heavy(L.FR_CTX)
    heavy = torch.cat([heavy_a, heavy_b])

    def operands(counts, n):
        w = rand_field(L.FR_CTX, (sum(counts) + len(counts)) * n + max(counts) - 3)
        at = torch.randperm(w.shape[0], device=dev)[: heavy.shape[0]]
        w[at] = heavy[: at.shape[0]]
        rows = list(w[: sum(counts) * n].reshape(-1, n, 8))
        stacks, first = [], 0
        for m in counts:
            stacks.append(rows[first : first + m])
            first += m
        pows = list(w[sum(counts) * n : (sum(counts) + len(counts)) * n].reshape(-1, n, 8))
        return stacks, pows, w[-max(counts):].contiguous()

    n = 1 << 16
    rows = sum(OPEN_ROWS)
    stacks, pows, v_pows = operands(OPEN_ROWS, n)
    for kind, products, symbol in (("eval", rows, "open_eval_kernel"),
                                   ("combine", rows + len(OPEN_ROWS), "open_combine_kernel")):
        t0 = time.time()
        want = K.open_stack_plain(kind, stacks, pows, v_pows)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max(max_err(K.open_stack(kind, stacks, pows, v_pows), want)
                  for _ in range(SCAN_REPEATS))
        fn = lambda: K.open_stack(kind, stacks, pows, v_pows)
        nbytes = (rows + len(OPEN_ROWS)) * n * 32 + want.numel() * 4
        rep.add(f"open_{kind}", err=err, ms=timed(fn, 20), plain_ms=plain_ms, nbytes=nbytes,
                int_ops=products * n * MONT_MULS * WIDE, device_ms=device_ms(fn, 20, symbol),
                note=f" ({OPEN_ROWS} rows of 2^16 at three points, one launch, {SCAN_REPEATS} "
                     f"runs compared; plain: products and add trees over K-a)")
        del want
    del stacks, pows
    for counts, n in (((5, 2, 1), 1003), ((5, 2, 1), 3 * K.OPEN_EVAL_CHUNK + 5)):
        stacks, pows, v_pows = operands(counts, n)
        cpu = ([[r.cpu() for r in rs] for rs in stacks], [p.cpu() for p in pows], v_pows.cpu())
        for kind in ("eval", "combine"):
            fn = lambda: K.open_stack(kind, stacks, pows, v_pows)
            err = max_err(fn().cpu(), K.open_stack(kind, *cpu))
            products = sum(counts) + (len(counts) if kind == "combine" else 0)
            rep.also(f"open_{kind}", f"{counts} rows of {n}, against the CPU plain version",
                     err=err, ms=timed(fn, 10), int_ops=products * n * MONT_MULS * WIDE)


def phase1_batch(rep: Report, dev, rand_field, carry_heavy):
    """K5, K6 and K7 over an instance axis, as the batched prover launches
    them: B = 4 instances at delay_enc k=16's shapes (2^16 rows; 2^19 on the
    extended coset; the openings' 47, 6 and 4 rows of 2^16 an instance),
    each with its own challenges, against the plain versions (the single-
    instance ones looped) on the card, K7 50 times over; at small ragged
    sizes with carry-heavy words against the plain versions on the CPU; and
    each batched launch against the same instances' single launches."""
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

    B = BATCH
    rng = np.random.default_rng(6)
    heavy_a, heavy_b = carry_heavy(L.FR_CTX)
    heavy = torch.cat([heavy_a, heavy_b])

    def consts(count):
        """Challenge words, other ones an instance."""
        return np.stack([K.challenge_words(*(int(v) for v in rng.integers(1, 2**62, 4)),
                                           [int(v) for v in rng.integers(1, 2**62, 6)])
                         for _ in range(count)])

    def stack(*shape, with_heavy=False):
        count = int(np.prod(shape))
        w = rand_field(L.FR_CTX, max(0, count - 3))[:count].reshape(*shape, 8)
        if with_heavy:
            flat = w.reshape(-1, 8)
            at = torch.randperm(flat.shape[0], device=dev)[: heavy.shape[0]]
            flat[at] = heavy[: at.shape[0]]
        return w

    def cpu(ts):
        return [t.cpu() for t in ts]

    # K5: (4, 6, 2^16) and (4, 8, 2^16) over one key
    n = 1 << 16
    c = consts(B)
    usable = n - 7
    fr_in = [stack(B, 6, n), stack(6, n), stack(n), stack(len(ALL_FIXED), n), stack(B, 8, n)]
    got = K.gp_fracs(*fr_in, c, usable)
    want = K.gp_fracs_plain(*fr_in, c, usable)
    err = max(max_err(g, w) for g, w in zip(got, want))
    for b in range(B):  # the single launches give the batch's rows
        one = K.gp_fracs(fr_in[0][b], *fr_in[1:4], fr_in[4][b], c[b], usable)
        err = max(err, *(max_err(o, g[5 * b : 5 * b + 5]) for o, g in zip(one, got)))
    fn = lambda: K.gp_fracs(*fr_in, c, usable)
    rep.also("gp_fracs", f"B={B} instances of 2^16 rows, one launch, each its own challenges",
             err=err, ms=timed(fn, 20), device_ms=device_ms(fn, 20, "fracs_kernel"),
             nbytes=(B * 24 + 13) * n * 32, int_ops=B * usable * FRACS_MULS * MONT_MULS * WIDE,
             note=" (plain: the single-instance plain version looped; each instance also "
                  "against its own single launch)")
    del fr_in, got, want
    n_small = 1003
    c3 = consts(3)
    small = [stack(3, 6, n_small, with_heavy=True), stack(6, n_small, with_heavy=True),
             stack(n_small, with_heavy=True), stack(len(ALL_FIXED), n_small, with_heavy=True),
             stack(3, 8, n_small, with_heavy=True)]
    got = K.gp_fracs(*small, c3, n_small - 9)
    want = K.gp_fracs(*cpu(small), c3, n_small - 9)
    rep.also("gp_fracs", f"B=3 instances of {n_small} rows, carry-heavy words, against the CPU "
             f"plain version", err=max(max_err(g.cpu(), w) for g, w in zip(got, want)),
             ms=timed(lambda: K.gp_fracs(*small, c3, n_small - 9), 10),
             int_ops=3 * n_small * FRACS_MULS * MONT_MULS * WIDE)

    # K6: (4, 19, 2^19) over the shared key stack, one launch
    n_ext = 1 << 19
    q_in = [stack(B, K.WIT_ROWS, n_ext), stack(len(KEY_ROWS), n_ext), stack(n_ext), stack(8)]
    got = K.quotient_h(*q_in, c)
    want = K.quotient_h_plain(*q_in, c)
    err = max_err(got, want)
    del want
    for b in range(B):
        err = max(err, max_err(K.quotient_h(q_in[0][b], *q_in[1:], c[b]), got[b]))
    fn = lambda: K.quotient_h(*q_in, c)
    rep.also("quotient_h", f"B={B} instances of 2^19 rows, one launch, each its own challenges",
             err=err, ms=timed(fn, 5), device_ms=device_ms(fn, 5, "quotient_kernel"),
             nbytes=(B * 20 + 25) * n_ext * 32,
             int_ops=B * n_ext * QUOTIENT_MULS * MONT_MULS * WIDE,
             note=" (plain: the single-instance composition over K-a looped; each instance "
                  "also against its own single launch)")
    del q_in, got
    n_small = 8 * 65
    small = [stack(3, K.WIT_ROWS, n_small, with_heavy=True),
             stack(len(KEY_ROWS), n_small, with_heavy=True), stack(n_small, with_heavy=True),
             heavy[:8].contiguous()]
    got = K.quotient_h(*small, c3)
    rep.also("quotient_h", f"B=3 instances of {n_small} rows, carry-heavy words, against the "
             f"CPU plain version", err=max_err(got.cpu(), K.quotient_h(*cpu(small), c3)),
             ms=timed(lambda: K.quotient_h(*small, c3), 10),
             int_ops=3 * n_small * QUOTIENT_MULS * MONT_MULS * WIDE)

    # K7: four tables of the openings' stacks, one launch each contraction
    def operands(counts_b, n):
        stacks_b, pows_b, v_b = [], [], []
        for counts in counts_b:
            rows = list(stack(sum(counts), n, with_heavy=True))
            stacks, first = [], 0
            for m in counts:
                stacks.append(rows[first : first + m])
                first += m
            stacks_b.append(stacks)
            pows_b.append(list(stack(len(counts), n)))
            v_b.append(stack(max(counts)))
        return stacks_b, pows_b, v_b

    counts_b = [OPEN_ROWS] * B
    ops = operands(counts_b, 1 << 16)
    rows = sum(OPEN_ROWS)
    for kind, products, symbol in (("eval", rows, "open_eval_kernel"),
                                   ("combine", rows + len(OPEN_ROWS), "open_combine_kernel")):
        want = K.open_stacks_plain(kind, *ops)
        err = max(max_err(K.open_stacks(kind, *ops), want) for _ in range(SCAN_REPEATS))
        fn = lambda: K.open_stacks(kind, *ops)
        rep.also(f"open_{kind}", f"B={B} tables of {OPEN_ROWS} rows of 2^16, one launch",
                 err=err, ms=timed(fn, 20), device_ms=device_ms(fn, 20, symbol),
                 nbytes=B * (rows + len(OPEN_ROWS)) * (1 << 16) * 32 + want.numel() * 4,
                 int_ops=B * products * (1 << 16) * MONT_MULS * WIDE,
                 note=f" ({SCAN_REPEATS} runs compared; plain: the single-instance plain "
                      f"version looped)")
        del want
    del ops
    ragged = [(5, 2, 1), (1,), (3, 3)]
    for n in (1003, 3 * K.OPEN_EVAL_CHUNK + 5):
        ops = operands(ragged, n)
        cpu_ops = ([[cpu(r) for r in st] for st in ops[0]], [cpu(p) for p in ops[1]],
                   cpu(ops[2]))
        for kind in ("eval", "combine"):
            fn = lambda: K.open_stacks(kind, *ops)
            products = sum(map(sum, ragged)) + (sum(map(len, ragged)) if kind == "combine" else 0)
            rep.also(f"open_{kind}", f"tables of {ragged} rows of {n}, one launch, against the "
                     f"CPU plain version", err=max_err(fn().cpu(), K.open_stacks(kind, *cpu_ops)),
                     ms=timed(fn, 10), int_ops=products * n * MONT_MULS * WIDE)


def shard_cost(ndev: int, shards, inverse: bool, l_len: int, stages: bool) -> tuple:
    """(bytes, integer multiply-adds) of one K12 launch for the shards
    `shards` of D: every block read, the card's outputs written; for the
    stages also the twiddle rows and Montgomery products of the nodes its
    outputs need (parallel/ntt.py node_masks), and 1/N."""
    from delay_enc_tpu_torch.parallel import ntt as PN

    s = len(shards)
    if not stages:
        return 2 * 32 * s * l_len, 0
    m = ndev.bit_length() - 1
    rows, products = set(), s if inverse else 0
    for need, st in zip(PN.node_masks(ndev, shards, inverse), PN.stage_order(m, inverse)):
        h = ndev >> (st + 1)
        for t in range(ndev):
            b = t + h
            if t & h or not need >> t & 1 and not need >> b & 1:
                continue
            if inverse or need >> b & 1:
                rows.add(PN.row_index(ndev, st, b))
                products += 1
    nbytes = 32 * l_len * (ndev + len(rows) + s) + (32 if inverse else 0)
    return nbytes, products * l_len * MONT_MULS * WIDE


def phase1_shard(rep: Report, dev, rand_field, carry_heavy):
    """K12's two kernels, `shard_stages` (the m cross-shard stages in
    registers) and `shard_reshuffle`, forward and inverse, against their
    plain versions on the card, bit-exact, on random blocks with every
    carry-heavy pair spread among them: the main rows at delay_enc k=16
    over D = 4 (L = 2^14) with the four shards on the card; at that size
    every single shard and pair as the card's own (a card of make_mesh(4)
    holds one; its path is one of the network's); D = 2 and D = 8 at k=16;
    D = 4 at k=20 (L = 2^18), where the card and not the launch sets the
    time.  Each line has its device time, bound and plain time; the
    reshuffle's lines over all shards also the library's: one
    `index_select` of the stacked blocks' 32-byte rows by the fixed
    permutation, checked equal to the kernel's output."""
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.parallel import ShardedNTTPlan
    from delay_enc_tpu_torch.parallel import ntt as PN

    ha, hb = carry_heavy(L.FR_CTX)
    heavy = torch.cat([ha, hb])

    def blocks_of(ndev, l_len):
        """The stacked (D L, 8) words and the D blocks, views of it."""
        w = rand_field(L.FR_CTX, ndev * l_len - 3)
        spots = torch.arange(heavy.shape[0], device=dev) * (ndev * l_len // heavy.shape[0])
        w[spots] = heavy
        return w, list(w.reshape(ndev, l_len, 8))

    def reshuffle_rows(ndev, l_len, inverse):
        """The reshuffle of all D blocks as one permutation of the stack's
        rows: each output row's source row.  Forward out[q][t D + r] =
        y[rev(r)][q L/D + t]; inverse out[b][q L/D + t] = x[q][t D + rev(b)]."""
        m = ndev.bit_length() - 1
        rev = torch.tensor([int(format(r, f"0{m}b")[::-1], 2) for r in range(ndev)], device=dev)
        a, t = torch.arange(ndev, device=dev), torch.arange(l_len // ndev, device=dev)
        if not inverse:
            src = rev[None, None, :] * l_len + a[:, None, None] * (l_len // ndev) + t[None, :, None]
        else:
            src = a[None, :, None] * l_len + t[None, None, :] * ndev + rev[:, None, None]
        return src.reshape(-1)

    def plain_of(fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    for k, ndev in ((16, 4), (16, 2), (16, 8), (20, 4)):
        l_len = (1 << k) // ndev
        plan = ShardedNTTPlan.make(k, ndev, dev)
        stacked, blocks = blocks_of(ndev, l_len)
        every = tuple(range(ndev))
        main = (k, ndev) == (16, 4)
        reps = 20 if k == 20 else 50
        for name, stages in (("shard_stages", True), ("shard_reshuffle", False)):
            for inverse in (False, True):
                if stages:
                    rows = (plan.rows_inv if inverse else plan.rows)[0]
                    fn = lambda sh=every: PN.shard_stages(dev, blocks, sh, rows, inverse=inverse,
                                                          n_inv=plan.n_inv[0])
                    plain = lambda sh=every: PN.shard_stages_plain(
                        blocks, rows, sh, inverse=inverse, n_inv=plan.n_inv[0])
                else:
                    fn = lambda sh=every: PN.shard_reshuffle(dev, blocks, sh, inverse=inverse)
                    plain = lambda sh=every: PN.shard_reshuffle_plain(blocks, sh, inverse=inverse)
                want, plain_ms = plain_of(plain)
                err = max_err(fn(), want)
                nbytes, ops = shard_cost(ndev, every, inverse, l_len, stages)
                shape = (f"D={ndev}, L=2^{k - ndev.bit_length() + 1} (k={k}), "
                         f"{'inverse' if inverse else 'forward'}, all shards on the card")
                dev_ms = device_ms(fn, reps, f"{name}_kernel")
                note = f" ({shape}; plain {plain_ms:.4f} ms; {heavy.shape[0]} carry-heavy words)"
                library_ms = None
                if not stages:
                    perm = reshuffle_rows(ndev, l_len, inverse)
                    library = lambda perm=perm: stacked.index_select(0, perm)
                    if not torch.equal(library().view(ndev, l_len, 8), fn()):
                        raise AssertionError(f"{name} {shape}: index_select by the reshuffle's "
                                             f"permutation differs from the kernel's output")
                    library_ms = timed(library, reps)
                    note += "; library: index_select of the stacked blocks' rows"
                if main and not inverse:
                    rep.add(name, err=err, ms=timed(fn, reps), plain_ms=plain_ms, nbytes=nbytes,
                            int_ops=ops, device_ms=dev_ms, note=note, library_ms=library_ms)
                else:
                    rep.also(name, shape, err=err, ms=timed(fn, reps), nbytes=nbytes,
                             int_ops=ops, device_ms=dev_ms, note=note, library_ms=library_ms)
                if not main:
                    continue
                # every single shard and pair as the card's own, against the whole output
                subsets = [(d,) for d in every] + [(0, 2), (1, 3), (3, 0)]
                err = max(max_err(fn(sh), want[list(sh)]) for sh in subsets)
                nbytes, ops = shard_cost(ndev, (3,), inverse, l_len, stages)
                rep.also(name, f"D=4, L=2^14, {'inverse' if inverse else 'forward'}, one shard of "
                         f"four as the card's own (timed: shard 3), every single shard and the "
                         f"pairs {subsets[4:]} compared", err=err, ms=timed(lambda: fn((3,)), reps),
                         nbytes=nbytes, int_ops=ops, device_ms=device_ms(lambda: fn((3,)), reps,
                                                                         f"{name}_kernel"))
        del plan, blocks, stacked


def mxu_step_cost(s, batch: int, with_t: bool) -> tuple:
    """(tensor-core multiply-adds, integer multiply-adds, bytes) of one K11
    product step over `batch` polynomials: 1024 byte pairs for each of the
    rows x kused x cols terms (the K rows that hold data); the epilogue's
    reduction (64 wide products) and, in the first step, the product by T;
    the fixed and data planes of those rows read once, T read, the output
    written."""
    elems = s.rows * s.cols
    tc = 1024 * elems * s.kused * batch
    ints = elems * batch * (64 * WIDE + (MONT_MULS * WIDE if with_t else 0))
    nbytes = 32 * s.kused * (s.rows + s.cols * batch) + 32 * elems * (batch + int(with_t))
    return tc, ints, nbytes


def mxu_transform_cost(plan, rows: int, n_in: int) -> tuple:
    """The same for a whole transform of `rows` polynomials of n_in
    elements: both product steps, and the splits' bytes (the source read,
    the planes written)."""
    from delay_enc_tpu_torch.ops import ntt_mxu as X

    tc = ints = nbytes = 0
    for s, with_t in zip(X.steps(plan, n_in), (True, False)):
        a, b, c = mxu_step_cost(s, rows, with_t)
        tc, ints, nbytes = tc + a, ints + b, nbytes + c + 64 * s.kused * s.cols * rows
    return tc, ints, nbytes


def mxu_fold_plan(k: int, kind: str, dev):
    """The plan of one of the prover's four transforms at length 2^k: a
    domain's "fwd" and "inv" at its k, "ext" and "ext_inv" at its k + 3."""
    from delay_enc_tpu_torch.plonk.domain import EXT_LOG, Domain

    return Domain(k if kind in ("fwd", "inv") else k - EXT_LOG).mxu_plan(kind, dev)


def mxu_limit_check(dev) -> str:
    """The product at its accumulators' limit on the card: every entry of a
    64 x 1024 fixed operand and of 1024 x 8 data p - 1 (n1 = 1024), so every
    column holds its most plane products, without T and with T all p - 1;
    against the plain version and Python integers."""
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt_mxu as X

    p, r_ = L.FR_CTX.p, 1 << 256
    kk, m, q = X.MAX_SIDE, X.TILE_M, X.TILE_N
    full = L.to_tensor(L.ints_to_words_np([p - 1]), dev)
    s = X.StepShape(m, q, kk, kk * q, q, 1, kk)
    wf = X.frag_fixed(full.expand(m, kk, 8).contiguous())
    df = X.split(full.expand(1, kk * q, 8).contiguous(), s)
    v = kk * (p - 1) ** 2 * pow(r_, -1, p) % p
    t_full = full.expand(m * q, 8).contiguous()
    for t, want in ((None, v), (t_full, v * (p - 1) * pow(r_, -1, p) % p)):
        out = X.product(wf, df, t, s, torch.empty((1, m * q, 8), dtype=torch.int32, device=dev))
        got = L.words_to_ints_np(L.to_numpy(out[0]))
        if set(got) != {want} or not torch.equal(out, X.product_plain(wf, df, t, s)):
            raise AssertionError(f"ntt_mxu_product at the accumulators' limit (T {t is not None}) "
                                 f"disagrees")
    return f"{m} x {q} elements of K = {kk}, every entry p - 1, without and with T: bit-exact"


def mxu_sass_counts(build: str) -> dict:
    """Instructions of mxu_product_kernel in the SASS of build/libntt_mxu.so
    (cuobjdump -sass): warpgroup MMAs (*GMMA) and mma.sync ones (IMMA, HMMA),
    with the opcodes seen."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", os.path.join(build, "libntt_mxu.so")],
                         capture_output=True, text=True, check=True).stdout
    counts = {"warpgroup_mma": 0, "mma_sync": 0, "opcodes": set()}
    fn = ""
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        if "mxu_product_kernel" not in fn:
            continue
        for op in re.findall(r"\b([A-Z]*GMMA)(\.[\w.]+)?", line):
            counts["warpgroup_mma"] += 1
            counts["opcodes"].add("".join(op))
        if re.search(r"\b[IH]MMA\b", line):
            counts["mma_sync"] += 1
    counts["opcodes"] = sorted(counts["opcodes"])
    return counts


def phase1_mxu(rep: Report, dev, rand_field, carry_heavy):
    """K11, the matmul NTT (csrc/ntt_mxu.cu).  The product (with its fused
    reduction and product by T) and the split alone at the (6, 2^16)
    forward transform's two steps (the sigma forward) against their plain
    versions on the same planes, with torch._int_mm over the same plane
    products as the library's time for the product stage; the whole
    transform at k = 4..10 in every fold, on rows with the carry-heavy
    values and on rows of n/8 elements, against the four-step plain version
    on the card; against K-b at the proof's shapes (the (6, 2^16) inverse
    and forward, the (19, 2^16) coset transform to 2^19, the (1, 2^19)
    quotient inverse) and at (1, 2^20) (n1 = n2 = 1024); the reduction alone
    on the adversarial columns (off the path: the product runs it)."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.ops import ntt_mxu as X
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.domain import Domain

    ctx = L.FR_CTX
    t_phase = time.time()
    d = Domain(16)
    n = d.n
    fwd = d.mxu_plan("fwd", dev)
    x6 = rand_field(ctx, 6 * n - 3).reshape(6, n, 8)
    s1, s3 = X.steps(fwd, n)
    d1 = X.split(x6, s1)
    c = X.product(fwd.w1_frag, d1, fwd.t, s1, torch.empty_like(x6))
    d3 = X.split(c, s3)
    y = X.product(fwd.w2_frag, d3, None, s3, torch.empty_like(x6))

    # the product alone, both steps, against its plain version on the same planes
    def products():
        X.product(fwd.w1_frag, d1, fwd.t, s1, c)
        X.product(fwd.w2_frag, d3, None, s3, y)

    t0 = time.time()
    want_c = X.product_plain(fwd.w1_frag, d1, fwd.t, s1)
    want_y = X.product_plain(fwd.w2_frag, d3, None, s3)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max(max_err(c, want_c), max_err(y, want_y))
    del want_c, want_y

    # the library's product stage: torch._int_mm of the same plane products
    # (int8 operands, no column sums, no reduction), timed, used nowhere
    def int_mm_operands(frag, planes, s):
        a = X.fixed_planes(frag)[:, : s.rows, : s.ktiles * X.TILE_K].contiguous()
        b = X.data_planes(planes)[:, :, : s.cols].contiguous()
        return (a.reshape(-1, a.shape[-1]).view(torch.int8),
                b.reshape(-1, b.shape[-1]).view(torch.int8))

    mm = [int_mm_operands(fwd.w1_frag, d1, s1), int_mm_operands(fwd.w2_frag, d3, s3)]
    library_ms = timed(lambda: [torch._int_mm(a, b.t()) for a, b in mm], 3)
    del mm
    cost = [mxu_step_cost(s, 6, t) for s, t in ((s1, True), (s3, False))]
    rep.add("ntt_mxu_product", err=err, ms=timed(products, 10), plain_ms=plain_ms,
            nbytes=sum(c_[2] for c_ in cost), int_ops=sum(c_[1] for c_ in cost),
            tc_ops=sum(c_[0] for c_ in cost), library_ms=library_ms,
            device_ms=device_ms(products, 10, "mxu_product_kernel"),
            note=f" (the two steps of the (6, 2^16) forward, n1 = n2 = 256, K = 256; "
                 f"library: torch._int_mm of the same 2 x 1024 plane products, s8, without "
                 f"the column sums and the reduction)")

    def splits():
        X.split(x6, s1)
        X.split(c, s3)

    t0 = time.time()
    err = max(max_err(X.split(x6, s1).view(torch.int32), X.split_plain(x6, s1).view(torch.int32)),
              max_err(X.split(c, s3).view(torch.int32), X.split_plain(c, s3).view(torch.int32)))
    plain_ms = (time.time() - t0) * 1e3
    rep.add("ntt_mxu_split", err=err, ms=timed(splits, 20), plain_ms=plain_ms,
            nbytes=2 * 2 * 32 * 6 * n, int_ops=0,
            device_ms=device_ms(splits, 20, "mxu_split_kernel"),
            note=" (the two steps of the (6, 2^16) forward: A, and C read transposed)")
    del x6, d1, d3, c, y

    print(f"phase 1 ntt_mxu_product at the accumulators' limit: {mxu_limit_check(dev)}",
          flush=True)
    sass = mxu_sass_counts(_cuda.BUILD)
    print(f"phase 1 ntt_mxu_product resources: {json.dumps(X.product_attrs())}; SASS of "
          f"mxu_product_kernel: {json.dumps(sass)}", flush=True)
    if sass["warpgroup_mma"] == 0 or sass["mma_sync"] != 0:
        raise AssertionError("mxu_product_kernel is not built from warpgroup MMAs alone")

    # every fold at k = 4..10, rows holding 0, 1, p - 1 and the carry-heavy
    # values, full rows and rows of n/8 elements, against the four-step plain
    ha, _ = carry_heavy(ctx)
    heavy = ha[:: int(round(ha.shape[0] ** 0.5))]
    err, count = 0, 0
    for k in range(4, 11):
        m = 1 << k
        x = rand_field(ctx, 3 * m - 3).reshape(3, m, 8)
        x[0, : heavy.shape[0]] = heavy[:m]
        for kind in Domain.MXU_KINDS:
            small = mxu_fold_plan(k, kind, dev)
            for rows in (x, x[:, : m // 8].contiguous()):
                err = max(err, max_err(X.ntt_mxu_stack(small, rows),
                                       X.ntt_mxu_plain(small, rows)))
                count += 1
    tc, ints, nbytes = mxu_transform_cost(small, 3, 1 << 10)
    rep.also("ntt_mxu_product", f"k=4..10, every fold, batch 3, full and n/8 rows ({count} "
             f"transforms); timed: whole transform (3, 2^10), ext_inv", err=err,
             ms=timed(lambda: X.ntt_mxu_stack(small, x), 10), tc_ops=tc, int_ops=ints,
             nbytes=nbytes, note=f" (against ntt_mxu_plain; {heavy.shape[0]} carry-heavy "
                                 f"values in the first row)")

    # against K-b at the proof's shapes
    plan, plan_ext = d.plan(dev), d.plan_ext(dev)
    zeta_powers = N.powers(ctx, d.zeta, n, dev)
    unscale = N.powers(ctx, L.FR_CTX.field.inv(d.zeta), d.n_ext, dev,
                       L.FR_CTX.field.inv(d.n_ext))
    inv_in = rand_field(ctx, 6 * n - 3).reshape(6, n, 8)
    coeff = rand_field(ctx, 19 * n - 3).reshape(19, n, 8)
    h_ext = rand_field(ctx, d.n_ext - 3).reshape(1, d.n_ext, 8)
    k20 = rand_field(ctx, (1 << 20) - 3).reshape(1, 1 << 20, 8)
    plan20 = N.NTTPlan.make(ctx, 20, dev)
    cases = (
        ("(6, 2^16) inverse, 1/n folded", d.mxu_plan("inv", dev), inv_in,
         lambda: K._coeff(inv_in, plan)),
        ("(6, 2^16) forward", fwd, inv_in, lambda: N.stockham(ctx, inv_in, plan.tw)),
        ("(19, 2^16) -> (19, 2^19) on zeta H_ext, zeta^j folded, 64 of A's 512 rows",
         d.mxu_plan("ext", dev), coeff, lambda: K._ext(coeff, zeta_powers, plan_ext)),
        ("(1, 2^19) inverse, 1/n_ext and zeta^-i folded", d.mxu_plan("ext_inv", dev), h_ext,
         lambda: N.stockham(ctx, h_ext, plan_ext.tw_inv, out_scale=unscale)),
        ("(1, 2^20) forward, n1 = n2 = 1024", mxu_fold_plan(20, "fwd", dev), k20,
         lambda: N.stockham(ctx, k20, plan20.tw)),
    )
    for shape, mp, rows, kb in cases:
        fn = lambda: X.ntt_mxu_stack(mp, rows)
        err = max_err(fn(), kb())
        tc, ints, nbytes = mxu_transform_cost(mp, rows.shape[0], rows.shape[1])
        kb_ms = timed(kb, 5)
        rep.also("ntt_mxu_product", f"whole transform {shape}", err=err, ms=timed(fn, 3),
                 tc_ops=tc, int_ops=ints, nbytes=nbytes,
                 device_ms=device_ms(fn, 3, "mxu_product_kernel"),
                 note=f" (against K-b, bit-exact; K-b {kb_ms:.4f} ms by CUDA events; "
                      f"{X.launches(mp.n, rows.shape[0])} launches of each K11 kernel)")
    del inv_in, coeff, h_ext, k20, plan20

    # the reduction alone on the adversarial columns and on 2^16 random ones
    p, r_ = ctx.p, 1 << 256
    vals = [0, 1, p - 1, p, p + 1, r_ - 1, r_, r_ * p - 1, 1024 * (p - 1) ** 2, (1 << 518) - 1,
            ((1 << 262) - 1) * r_, (3 * p - 1) * r_, 3 * p * r_, (p - 1) * r_]
    cols = [[(v >> (8 * c_)) & 0xFF for c_ in range(X.COLS - 1)] + [v >> (8 * (X.COLS - 1))]
            for v in vals]
    adv = torch.tensor(cols, dtype=torch.int32, device=dev)
    got = L.words_to_ints_np(L.to_numpy(X.reduce_columns(adv)))
    want = [v * pow(r_, -1, p) % p for v in vals]
    err = int(got != want)
    big = torch.randint(0, 1 << 29, (1 << 16, X.COLS), generator=torch.Generator(device=dev)
                        .manual_seed(5), device=dev, dtype=torch.int32)
    big[:, X.COLS - 1] >>= 9  # V < 2^517 (1 + 2^-8) + 2^516 < 2^518
    fn = lambda: X.reduce_columns(big)
    got = fn()
    t0 = time.time()
    want = X.reduce_columns_plain(big.to(torch.int64))
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max(err, max_err(got, want))
    rep.add("ntt_mxu_reduce", err=err, ms=timed(fn, 20), plain_ms=plain_ms,
            nbytes=(1 << 16) * (4 * X.COLS + 32), int_ops=(1 << 16) * 64 * WIDE,
            device_ms=device_ms(fn, 20, "mxu_reduce_kernel"),
            note=f" (2^16 random column sets below 2^29 and {len(vals)} adversarial values "
                 f"against Python integers)")
    log(f"  phase 1 K11: {time.time() - t_phase:.2f} s")


def k7_circuit(x0: int = 7, y0: int = 11):
    """The k=7 circuit of tests/test_torch_prover.py for the witness (x0, y0)."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR

    b = cs.Builder(FR)
    mg, rc = cs.MainGate(b), cs.RangeChip(b)
    x, y = mg.assign_value(x0), mg.assign_value(y0)
    s, m = mg.add(x, y), mg.mul(x, y)
    acc = mg.compose([cs.Term(x, 2), cs.Term(y, 3), cs.Term(s, 1), cs.Term(m, 5)], constant=9)
    sel = mg.select(s, m, mg.assign_bit(1))
    mg.assert_equal(sel, s)
    rc.assign(45, 2, 6)
    mg.assert_one(mg.is_equal(acc, mg.assign_value(acc.value)))
    return b


def golden_k7(dev):
    """SRS setup, keygen and create_proof of the k=7 circuit of
    tests/test_torch_prover.py on the card, against the JAX package's bytes
    for the same tau and rng seed (tests/data/torch_port_k7.npz).  Returns
    the SRS and the keys."""
    from delay_enc_tpu_torch.curves.bn254 import g1_to_bytes
    from delay_enc_tpu_torch.ops import msm as M
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    t0 = time.time()
    b = k7_circuit()
    srs = SRS.setup(7, tau=123456789, device=dev)
    pk, vk = keygen(b, srs, device=dev)
    proof = create_proof(srs, pk, b, np.random.default_rng(42), device=dev)

    def pts(ps):
        return np.stack([np.frombuffer(g1_to_bytes(p), np.uint8) for p in ps])

    got = {"srs": pts(M.points_from_device(srs.g1_powers)),
           "fixed": pts([vk.fixed_commitments[n] for n in ALL_FIXED]),
           "sigma": pts(vk.sigma_commitments),
           "transcript_repr": np.array(str(vk.transcript_repr)),
           "proof": np.frombuffer(proof, np.uint8)}
    with np.load(os.path.join(ROOT, "tests", "data", "torch_port_k7.npz")) as z:
        for key, have in got.items():
            want = z[key]
            if have.shape != want.shape or not np.array_equal(have, want):
                raise AssertionError(f"k=7 on the card: {key} differs from the JAX package's")
    if create_proof(srs, pk, b, np.random.default_rng(42), device=dev, ntt="mxu") != proof:
        raise AssertionError("k=7 on the card with ntt='mxu': the proof differs from the JAX "
                             "package's")
    print(f"phase 0 golden k=7: SRS points, {len(ALL_FIXED)} fixed + "
          f"{len(vk.sigma_commitments)} sigma commitments, transcript_repr and the "
          f"{len(proof)} proof bytes equal the JAX package's, with ntt='mxu' too "
          f"({time.time() - t0:.2f} s)", flush=True)
    return srs, pk, vk


def batch_k7(dev, srs, pk, vk) -> None:
    """The batched k=7 proofs of the witnesses (7, 11) and (3, 5) from
    default_rng(1), in both MSM bases, against the JAX package's
    (tests/data/torch_port_batch_k7.npz); then three proofs pipelined two
    deep against the serial ones for the same seeds."""
    from delay_enc_tpu_torch.plonk import (create_proof, create_proofs_batched,
                                           create_proofs_pipelined, verify_proof)

    t0 = time.time()
    with np.load(os.path.join(ROOT, "tests", "data", "torch_port_batch_k7.npz")) as z:
        builders = [k7_circuit(*(int(v) for v in w)) for w in z["witnesses"]]
        want, seed = [p.tobytes() for p in z["proofs"]], int(z["seed"])
    for msm in ("b4", "b16"):
        got = create_proofs_batched(srs, pk, builders, np.random.default_rng(seed), device=dev,
                                    msm=msm)
        if got != want:
            raise AssertionError(f"the batched k=7 proofs ({msm}) differ from the JAX package's")
    if not all(verify_proof(srs, vk, p) for p in want):
        raise AssertionError("a batched k=7 proof does not verify")
    seeds = [11, 22, 33]
    three = [k7_circuit(*w) for w in ((4, 9), (6, 13), (2, 3))]
    piped = create_proofs_pipelined(srs, pk, three, seeds=seeds, depth=2, device=dev)
    serial = [create_proof(srs, pk, b, np.random.default_rng(s), device=dev)
              for b, s in zip(three, seeds)]
    if piped != serial or not all(verify_proof(srs, vk, p) for p in piped):
        raise AssertionError("the pipelined k=7 proofs differ from the serial ones")
    print(f"phase 0 batched k=7: B={len(builders)} proofs in both MSM bases equal the JAX "
          f"package's batch, and verify; 3 proofs pipelined two deep equal the serial ones "
          f"({time.time() - t0:.2f} s)", flush=True)


def check_vk(vk, want, what: str) -> None:
    """vk's commitments and transcript_repr against the committed vk."""
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    for name in ALL_FIXED:
        if vk.fixed_commitments[name] != want.fixed_commitments[name]:
            raise AssertionError(f"{what}: fixed commitment {name} differs from the committed vk")
    if vk.sigma_commitments != want.sigma_commitments:
        raise AssertionError(f"{what}: sigma commitments differ from the committed vk")
    if vk.transcript_repr != want.transcript_repr:
        raise AssertionError(f"{what}: transcript_repr differs from the committed vk")


def vk_affine(pts) -> np.ndarray:
    """(m, 2, 32) uint8: each affine point's x and y, little-endian; the
    point at infinity as zeros (the goldens' encoding)."""
    out = np.zeros((len(pts), 2, 32), np.uint8)
    for i, p in enumerate(pts):
        if p is not None:
            for j, v in enumerate(p):
                out[i, j] = np.frombuffer(int(v).to_bytes(32, "little"), np.uint8)
    return out


def vk_parity(phase: str, workload: str, b, vk, msm: str, t_key: float) -> None:
    """The port's vk of (workload, k) against the JAX package's
    (tests/data/torch_port_vk_<workload>_k<k>.npz), byte for byte: the
    commitments as affine coordinates, transcript_repr, k and the circuit's
    rows.  Prints one line; a difference raises.  A row without a golden
    (not in VK_GOLDENS) is not checked."""
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    k = vk.domain.k
    if (workload, k) not in VK_GOLDENS:
        return
    path = VK_GOLDEN.format(workload, k)
    with np.load(path) as z:
        want = {key: z[key] for key in z.files}
    have = {"k": np.array(k), "rows": np.array(b.rows), "fixed_names": np.array(ALL_FIXED),
            "fixed": vk_affine([vk.fixed_commitments[n] for n in ALL_FIXED]),
            "sigma": vk_affine(vk.sigma_commitments),
            "transcript_repr": np.array(str(vk.transcript_repr))}
    diff = [key for key, v in have.items()
            if want[key].shape != v.shape or not np.array_equal(want[key], v)]
    print(f"{phase} vk_parity k={k} base={msm} equal={str(not diff).lower()}: {workload}, "
          f"{len(ALL_FIXED)} fixed + {len(vk.sigma_commitments)} sigma commitments and "
          f"transcript_repr against the JAX package's {os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path)} B); keygen {t_key:.3f} s", flush=True)
    if diff:
        raise AssertionError(f"{workload} k={k} msm={msm}: the vk's {diff} differ from the JAX "
                             f"package's")


def vk_parity_b16(phase: str, workload: str, b, srs, k: int, dev) -> None:
    """keygen with msm="b16" on the same SRS and circuit, held to the JAX
    package's vk by `vk_parity`."""
    from delay_enc_tpu_torch.plonk import keygen

    if (workload, k) not in VK_GOLDENS:
        return
    t0 = time.time()
    _, vk = keygen(b, srs, k=k, device=dev, msm="b16")
    torch.cuda.synchronize()
    vk_parity(phase, workload, b, vk, "b16", time.time() - t0)


def spans(prefix=""):
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    return {k: round(v, 4) for k, v in GLOBAL_METRICS.snapshot().items() if k.startswith(prefix)}


KERNEL_SYMBOLS = {  # CUDA function -> the port's kernel, as the profiles name it
    "field_binary_kernel": "field (K-a)", "field_pow_kernel": "field_pow",
    "ntt_fused_kernel": "ntt_fused (K-b)",
    "scan_kernel": "field_scan",
    "quotient_kernel": "quotient_h (K6, and its coset form for K9)",
    "fracs_kernel": "gp_fracs (K5)",
    "open_eval_kernel": "open_eval (K7)", "open_combine_kernel": "open_combine (K7)",
    "plane_sums_kernel": "plane_sums (K-c)", "plane_sums16_kernel": "plane_sums16",
    "pair_sel_kernel": "pair_sel", "g1_add_kernel": "g1_complete_add (K-d)",
    "fixed_base_kernel": "g1_fixed_base_mul", "shard_stages_kernel": "shard_stages (K12)",
    "shard_reshuffle_kernel": "shard_reshuffle (K12)",
    "mxu_split_kernel": "ntt_mxu_split (K11)", "mxu_product_kernel": "ntt_mxu_product (K11)",
    "mxu_reduce_kernel": "ntt_mxu_reduce (K11)",
}


def profile_run(run, phase: str, what: str) -> dict:
    """One more run of `run` under torch.profiler: device kernel time by
    kernel (the port's own, and PyTorch's copies and elementwise ops, the
    largest of those by name) against the run's wall time, so the device's
    idle share shows.  Returns the wall and device ms, the idle share and
    `by_kernel` {kernel: [ms, launches]}, empty (and the share None) if the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delay_enc_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    before = sum(_cuda.launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    launched = sum(_cuda.launch_counts().values()) - before
    groups: dict = {}
    torch_own: dict = {}

    def tally(table, key, us, count):
        g = table.setdefault(key, [0.0, 0])
        g[0] += us / 1e3
        g[1] += count

    for e in prof.key_averages():
        # the program's spans are record_function ranges, which the card
        # reports as user annotations covering their whole interval
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        name = KERNEL_SYMBOLS.get(kernel_function(e.key), "torch (other)")
        tally(groups, name, us, e.count)
        if name == "torch (other)":
            tally(torch_own, e.key[:90], us, e.count)
    busy = sum(g[0] for g in groups.values())
    if busy == 0:
        print(f"{phase} profile: {what} wall {wall_ms:.3f} ms; the profiler saw no device "
              f"time, idle share not measured", flush=True)
        return {"wall_ms": wall_ms, "device_ms": 0.0, "idle_share": None, "by_kernel": {}}
    detail = {k: {"ms": round(v[0], 4), "kernels": v[1]} for k, v in sorted(groups.items())}
    top = sorted(torch_own.items(), key=lambda kv: -kv[1][0])[:6]
    recorded = sum(g[1] for name, g in groups.items() if name != "torch (other)")
    print(f"{phase} profile: {what} wall {wall_ms:.3f} ms under the profiler, device kernels "
          f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.4f} ({recorded} of the port's "
          f"{launched} launches recorded); {json.dumps(detail)}; "
          f"largest of PyTorch's own: "
          f"{json.dumps({k: {'ms': round(v[0], 4), 'kernels': v[1]} for k, v in top})}",
          flush=True)
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "by_kernel": groups}


def profile_proof(srs, pk, builder, proof, dev, phase: str, msm: str = "b4",
                  ntt: str = "stockham") -> dict:
    """One more proof from default_rng(0) under torch.profiler
    (`profile_run`); it must equal `proof`."""
    from delay_enc_tpu_torch.plonk import create_proof

    def run():
        if create_proof(srs, pk, builder, np.random.default_rng(0), device=dev, msm=msm,
                        ntt=ntt) != proof:
            raise AssertionError("the profiled proof differs from the first")

    return profile_run(run, phase, "proof")


# K-a launches a proof or a batch, whatever B (one pipeline, plonk/prover.py),
# since K5, K6 and K7 took the fractions, the quotient and the openings: the
# advice and instance columns' Montgomery form (by R^2), the canonical form
# before each of 6 commitment batches, 4 products in the grand products'
# finish, and one product by the z^-(i+1) for every instance's three GWC
# divisions; no longer a function of k
PLANNED_ELEMENTWISE = 1 + COMMIT_BATCHES + 4 + 1
# field_wide_to_mont launches a proof or a batch: the random polynomials
PLANNED_WIDE = 1
# field_scan calls, each one launch: the powers of omega, the grand
# products' prefix, suffix and finishing products, the powers of every
# point, of every v and of every inverse point, and the GWC suffix sums of
# every point (a proof before one pipeline: 3 launches each for the points'
# powers, the inverse points' powers and the suffix sums, and 3 products)
PLANNED_SCANS = 1 + 3 + 1 + 1 + 1 + 1


def mxu_planned(k: int) -> int:
    """Launches of each K11 kernel in a fused proof at k with ntt='mxu':
    the 6, 8 and 5-row inverses and the 6 sigma forwards of length 2^k, the
    19-row coset transform and the quotient's inverse of length 2^(k+3)."""
    from delay_enc_tpu_torch.ops import ntt_mxu as X

    return (sum(X.launches(1 << k, rows) for rows in (6, 8, 5, 6))
            + X.launches(1 << (k + 3), 19) + X.launches(1 << (k + 3), 1))


def check_proof_launches(proof_launches: dict, k: int, msm: str = "b4",
                         split: bool = False, ntt: str = "stockham") -> None:
    """One proof at k: four transforms of length 2^k, then the quotient's
    transforms, each a launch a pass: on the fused path the coset transform
    and the inverse at 2^(k+3), in split mode the 8 cosets' transforms of
    length 2^k and the inverse at 2^(k+3); 14 scans and ladders of powers,
    each one launch (the powers of omega made on the card since PR 7; 39
    launches in 15 calls before the single-pass scan); one launch of K5, of
    K6 (fused) or 8 of its coset form (split), and of each of K7's two
    contractions, no subtraction, and the 13 elementwise launches that are
    left (81 before K7, 235 before K5 and K6, 910 before the scans); one
    selector launch a commitment batch, and the plane sums of the proof's base
    only.  With ntt='mxu' no K-b launch, and `mxu_planned(k)` of each K11
    kernel in their place; with 'stockham' no K11 launch."""
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.plonk.domain import MAX_DEGREE

    tree, other = ("plane_sums16", "plane_sums") if msm == "b16" else ("plane_sums", "plane_sums16")
    if proof_launches["pair_sel"] != COMMIT_BATCHES:
        raise AssertionError(f"a proof launched pair_sel {proof_launches['pair_sel']} times, "
                             f"planned {COMMIT_BATCHES}")
    if proof_launches[tree] == 0 or proof_launches[other] != 0:
        raise AssertionError(f"a {msm} proof launched {tree} {proof_launches[tree]} and {other} "
                             f"{proof_launches[other]} times")

    if split:
        want_ntt = (4 + MAX_DEGREE) * len(N.plan(k)) + len(N.plan(k + 3))
        quotient = {"quotient_h": 0, "quotient_h_coset": MAX_DEGREE}
    else:
        want_ntt = 4 * len(N.plan(k)) + len(N.plan(k + 3, 1 << k)) + len(N.plan(k + 3))
        quotient = {"quotient_h": 1, "quotient_h_coset": 0}
        if want_ntt > 20:
            raise AssertionError(f"the fused path plans {want_ntt} NTT launches, allowed 20")
    elementwise = proof_launches["field_mont_mul"]
    want_mxu = 0
    if ntt == "mxu":
        want_ntt, want_mxu = 0, mxu_planned(k)
    for name in ("ntt_mxu_split", "ntt_mxu_product"):
        if proof_launches[name] != want_mxu:
            raise AssertionError(f"a proof (ntt={ntt!r}) launched {name} "
                                 f"{proof_launches[name]} times, planned {want_mxu}")
    if proof_launches["ntt_fused"] != want_ntt:
        raise AssertionError(f"a proof launched the NTT kernel {proof_launches['ntt_fused']} "
                             f"times, planned {want_ntt}")
    if proof_launches["field_scan"] != PLANNED_SCANS:
        raise AssertionError(f"a proof launched the scan kernel {proof_launches['field_scan']} "
                             f"times, planned {PLANNED_SCANS}")
    for name, want in (("gp_fracs", 1), ("open_eval", 1), ("open_combine", 1),
                       ("field_wide_to_mont", PLANNED_WIDE), *quotient.items()):
        if proof_launches[name] != want:
            raise AssertionError(f"a proof launched {name} {proof_launches[name]} times, "
                                 f"planned {want}")
    for name in NOT_ON_PROOF:
        if proof_launches[name] != 0:
            raise AssertionError(f"a proof launched {name} {proof_launches[name]} times")
    if elementwise != PLANNED_ELEMENTWISE:
        raise AssertionError(f"a proof made {elementwise} elementwise product launches, planned "
                             f"{PLANNED_ELEMENTWISE}")


def check_batch_launches(launches: dict, k: int) -> None:
    """One batch at k, base 4, fused quotient: one launch each of K5, K6 and
    K7's two contractions for every instance, one selector launch a
    commitment call, the transforms and scans of one proof (batched by
    rows), and no plain version on the path: 11 K-a products, no sum, no
    subtraction (a plain K5, K6 or K7 would launch dozens)."""
    from delay_enc_tpu_torch.ops import ntt as N

    want = {"gp_fracs": 1, "quotient_h": 1, "open_eval": 1, "open_combine": 1,
            "quotient_h_coset": 0, "pair_sel": COMMIT_BATCHES, "plane_sums16": 0,
            "field_scan": PLANNED_SCANS, "field_mont_mul": PLANNED_ELEMENTWISE,
            "field_wide_to_mont": PLANNED_WIDE,
            "ntt_fused": 4 * len(N.plan(k)) + len(N.plan(k + 3, 1 << k)) + len(N.plan(k + 3)),
            "g1_complete_add": 0, "g1_fixed_base_mul": 0, "ntt_mxu_split": 0,
            "ntt_mxu_product": 0, **{name: 0 for name in NOT_ON_PROOF}}
    wrong = {name: (launches[name], n) for name, n in want.items() if launches[name] != n}
    if wrong or launches["plane_sums"] == 0:
        raise AssertionError(f"a batch launched (got, planned) {wrong}, plane_sums "
                             f"{launches['plane_sums']}")


def mxu_proof_phase(dev, card: str, srs, pk, builder, proof, phase: str) -> dict:
    """create_proof(ntt="mxu") on a fused key, after its K-b proofs: the four
    plans built first (seconds, bytes, launches), then a K-b proof and a K11
    proof from default_rng(0), each with the peak device memory from just
    before it; the K11 proof must equal `proof`, verify and launch no K-b
    (launches asserted); one more under torch.profiler.  Returns the K11
    proof's launch counts, set to 0 just before it and read just after."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import create_proof, verify_proof
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    domain = pk.vk.domain
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.time()
    plans = [domain.mxu_plan(kind, dev) for kind in domain.MXU_KINDS]
    torch.cuda.synchronize()
    t_plans = time.time() - t0
    plan_launches = {name: n for name, n in _cuda.launch_counts().items() if n}
    plan_bytes = sum(t.numel() * t.element_size() for mp in plans
                     for t in (mp.w1_frag, mp.w2_frag, mp.t))
    walls, peaks, spans_, launches = {}, {}, {}, {}
    for ntt in ("stockham", "mxu"):
        torch.cuda.reset_peak_memory_stats()
        GLOBAL_METRICS.clear()
        _cuda.reset_launches()
        t0 = time.time()
        got = create_proof(srs, pk, builder, np.random.default_rng(0), device=dev, ntt=ntt)
        torch.cuda.synchronize()
        walls[ntt] = time.time() - t0
        launches[ntt] = _cuda.launch_counts()
        peaks[ntt] = torch.cuda.max_memory_allocated()
        spans_[ntt] = spans("prove/")
        if got != proof:
            raise AssertionError(f"{phase}: the ntt={ntt!r} proof differs from the first K-b proof")
    if not verify_proof(srs, pk.vk, proof):
        raise AssertionError(f"{phase}: the proof does not verify")
    k = domain.k
    print(f"{phase} ntt='mxu' k={k} on {card}: four plans {t_plans:.4f} s on the card "
          f"({plan_bytes} B; launches {json.dumps(plan_launches)}); prove {walls['mxu']:.3f} s "
          f"against K-b {walls['stockham']:.3f} s in turn, the K-b proof's bytes, verifies; peak "
          f"device memory over the proof {peaks['mxu'] / 2**30:.3f} GiB against K-b "
          f"{peaks['stockham'] / 2**30:.3f} GiB (plans resident); spans {json.dumps(spans_)}; "
          f"the K11 proof's launches {json.dumps(launches['mxu'])}", flush=True)
    check_proof_launches(launches["stockham"], k)
    check_proof_launches(launches["mxu"], k, ntt="mxu")
    profile_proof(srs, pk, builder, proof, dev, f"{phase} ntt='mxu'", ntt="mxu")
    return launches["mxu"]


def batch_phase(dev, card: str, srs, pk, vk) -> dict:
    """delay_enc k=16, B = 4, on phase 4's SRS and base-4 key.  A delay_enc
    circuit has one witness: its puzzle (n, e, x) and the puzzle's answer
    are constants of the circuit (q_constant rows), and the in-circuit
    encryption equals the native one for the zero message only (README,
    fidelity notes).  So the batch is four builds of phase 4's statement,
    each proved with its own blinding.  create_proofs_batched twice from one rng seed
    (identical bytes, every proof verifying, launches asserted, peak device
    memory); create_proofs_pipelined two deep with seeds 1..4 against four
    serial create_proof calls; walls and proofs a second of the three; then
    bench.py's own batch draw (four puzzles, keyed on the first): only the
    first proof verifies; one more batch under torch.profiler.  Returns the
    launch counts of the first batch, its builders, its proofs, the walls of
    the two batches and their peak device memory."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import (create_proof, create_proofs_batched,
                                           create_proofs_pipelined, keygen, verify_proof)
    from delay_enc_tpu_torch.plonk.keygen import circuit_shape
    from delay_enc_tpu_torch.runtime.workloads import build_circuit
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    k = pk.vk.domain.k
    t0 = time.time()
    builders = [build_circuit("delay_enc", k) for _ in range(BATCH)]
    t_build = time.time() - t0
    if any(circuit_shape(b) != pk.shape for b in builders):
        raise AssertionError("a batch instance is not of the key's circuit")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    GLOBAL_METRICS.clear()
    _cuda.reset_launches()
    walls, runs = [], []
    for _ in range(2):
        t0 = time.time()
        runs.append(create_proofs_batched(srs, pk, builders, np.random.default_rng(0), device=dev))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        if len(runs) == 1:
            launches, batch_spans = _cuda.launch_counts(), spans("prove_batch/")
    peak = torch.cuda.max_memory_allocated()
    proofs = runs[0]
    if runs[1] != proofs:
        raise AssertionError("two batches from one rng seed differ")
    if len(set(proofs)) != BATCH or not all(verify_proof(srs, vk, p) for p in proofs):
        raise AssertionError("a batched delay_enc proof does not verify")
    check_batch_launches(launches, k)

    seeds = list(range(1, BATCH + 1))
    GLOBAL_METRICS.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    piped = create_proofs_pipelined(srs, pk, builders, seeds=seeds, depth=2, device=dev)
    torch.cuda.synchronize()
    t_pipe = time.time() - t0
    pipe_peak, pipe_spans = torch.cuda.max_memory_allocated(), spans("prove/")
    GLOBAL_METRICS.clear()
    t0 = time.time()
    serial = [create_proof(srs, pk, b, np.random.default_rng(s), device=dev)
              for b, s in zip(builders, seeds)]
    torch.cuda.synchronize()
    t_serial = time.time() - t0
    serial_spans = spans("prove/")
    if piped != serial or not all(verify_proof(srs, vk, p) for p in piped):
        raise AssertionError("the pipelined delay_enc proofs differ from the serial ones")
    rate = lambda wall: BATCH / wall
    print(f"phase 7 batch delay_enc k={k} B={BATCH} on {card}: circuits {t_build:.3f} s (host); "
          f"create_proofs_batched {walls[0]:.3f} s then {walls[1]:.3f} s (identical bytes, all "
          f"{BATCH} verify), {rate(walls[0]):.4f} then {rate(walls[1]):.4f} proofs/s, peak "
          f"device memory {peak / 2**30:.3f} GiB; create_proofs_pipelined depth 2 {t_pipe:.3f} s "
          f"({rate(t_pipe):.4f} proofs/s, peak {pipe_peak / 2**30:.3f} GiB) against {BATCH} "
          f"serial create_proof {t_serial:.3f} s ({rate(t_serial):.4f} proofs/s), the same "
          f"bytes; batch spans {json.dumps(batch_spans)}; pipelined spans (summed over the "
          f"workers) {json.dumps(pipe_spans)}; serial spans {json.dumps(serial_spans)}; a "
          f"batch's launches {json.dumps(launches)}", flush=True)

    # bench.py's batch draw: seeds 100..103 are four puzzles, and each
    # puzzle's answer is a constant of its circuit: the first one's key
    # proves the first only
    drawn = [build_circuit("delay_enc", k, seed=100 + i) for i in range(BATCH)]
    pk_b, vk_b = keygen(drawn[0], srs, device=dev)
    verified = [verify_proof(srs, vk_b, p) for p in
                create_proofs_batched(srs, pk_b, drawn, np.random.default_rng(0), device=dev)]
    del pk_b
    if verified != [True] + [False] * (BATCH - 1):
        raise AssertionError(f"bench.py's batch draw under its first key verified {verified}")
    print(f"phase 7 bench.py's batch draw (seeds 100..{99 + BATCH}, keyed on the first): the "
          f"proofs verify {verified}: four puzzles are four circuits", flush=True)

    def run():
        if create_proofs_batched(srs, pk, builders, np.random.default_rng(0), device=dev) != proofs:
            raise AssertionError("the profiled batch differs from the first")

    profile_run(run, "phase 7", f"batch of {BATCH}")
    return {"launches": launches, "builders": builders, "proofs": proofs, "walls": walls,
            "peak": peak}


def mesh_phase(dev, card: str, srs, pk, vk, k7: tuple, batch: dict) -> dict:
    """The sharded paths over a mesh of MESH_SHARDS shards: one a card where
    there are that many, else `Mesh.shared` on the one card (every stage and
    kernel runs; K12 reads the blocks inside its memory, not over NVLink).
    Inputs and the single-device references first; then, with the launch
    counts set to 0, the sharded NTT and iNTT of a k=16 column (launches
    asserted: one `shard_stages`, one K-b call over the card's stack of
    shards (its passes) and one `shard_reshuffle` a card and direction,
    nothing else), the sharded MSM of the 2^16 SRS points, batch_commit
    of 4 x 2^16 and two sharded batches of phase 7's delay_enc k=16 builders
    from its seed (the counts read after the first); then every result held
    to its reference: the single-device K-b ntt and intt, ops/msm.msm and
    the host's C MSM, serial commitments, phase 7's bytes and the verifier.
    Then the k=7 batch over 2 shards in both bases against the JAX golden,
    one sharded batch under the profiler, and dryrun_multichip.  Returns the
    counted launches."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import msm as M
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.parallel import (Mesh, ShardedNTTPlan, batch_commit,
                                              dryrun_multichip, make_mesh, sharded_intt,
                                              sharded_msm, sharded_ntt)
    from delay_enc_tpu_torch.plonk import create_proofs_batched, verify_proof
    from delay_enc_tpu_torch.plonk.selfcheck import msm_chunked

    d = MESH_SHARDS
    cards = torch.cuda.device_count()

    def mesh_of(size):
        if cards >= size:
            return make_mesh(size), f"make_mesh({size}): {size} of {cards} cards"
        return Mesh.shared(dev, size), f"Mesh.shared on one card ({cards} visible)"

    mesh, kind = mesh_of(d)
    where = ("inside one card, not over NVLink" if len(mesh.distinct) == 1
             else "of the other cards in place, peer to peer")

    def sync():
        for x in mesh.distinct:
            torch.cuda.synchronize(x)

    def wall_ms(fn, reps: int) -> float:
        """Mean host milliseconds of fn() over reps calls, every card of the
        mesh waited for (CUDA events time one card's stream only)."""
        sync()
        t0 = time.time()
        for _ in range(reps):
            fn()
        sync()
        return (time.time() - t0) * 1e3 / reps

    print(f"phase 9 mesh: torch.cuda.device_count() = {cards}; {d} shards by {kind}: "
          f"{[str(x) for x in mesh.devices]}", flush=True)
    k = pk.vk.domain.k
    n = 1 << k
    gen = torch.Generator(device=dev).manual_seed(9)

    def reduced(*shape):
        w = torch.randint(-2**31, 2**31, (*shape, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[..., 7] &= 0x0FFFFFFF  # below 2^252 < r
        return w

    column, scalars, coeff_batch = reduced(n), reduced(n), reduced(BATCH, n)
    single = N.NTTPlan.make(L.FR_CTX, k, dev)
    want_evals = N.ntt(single, column)
    if not torch.equal(N.intt(single, want_evals), column):
        raise AssertionError("the single-device K-b round trip lost the column")
    points = srs.truncated(k).g1_powers
    want_msm = M.points_from_device(M.msm(points, scalars)[None])[0]
    host = msm_chunked(L.words_to_ints_np(L.to_numpy(scalars)), M.points_from_device(points))
    if host != want_msm:
        raise AssertionError("ops/msm.msm of 2^16 points differs from the host's C MSM")
    want_commits = [M.points_from_device(M.msm(points, row)[None])[0] for row in coeff_batch]
    plan = ShardedNTTPlan.make(k, d, mesh.devices)
    m = plan.m

    # ---- the mesh's main path, counted ----------------------------------
    sync()
    torch.cuda.empty_cache()
    for x in mesh.distinct:
        torch.cuda.reset_peak_memory_stats(x)
    _cuda.reset_launches()
    evals = sharded_ntt(mesh, plan, column)
    back = sharded_intt(mesh, plan, evals)
    sync()
    ntt_launches = _cuda.launch_counts()
    got_msm = sharded_msm(mesh, points, scalars)
    commits = batch_commit(mesh, points, coeff_batch)
    sync()
    walls, runs = [], []
    for _ in range(2):
        t0 = time.time()
        runs.append(create_proofs_batched(srs, pk, batch["builders"], np.random.default_rng(0),
                                          mesh=mesh, axis=mesh.axis))
        sync()
        walls.append(time.time() - t0)
        if len(runs) == 1:
            launches = _cuda.launch_counts()
    peak = max(torch.cuda.max_memory_allocated(x) for x in mesh.distinct)

    cards_used = len(mesh.distinct)
    want_ntt = {"shard_stages": 2 * cards_used, "shard_reshuffle": 2 * cards_used,
                "ntt_fused": 2 * cards_used * len(N.plan(k - m))}
    wrong = {name: (count, want_ntt.get(name, 0)) for name, count in ntt_launches.items()
             if count != want_ntt.get(name, 0)}
    if wrong:
        raise AssertionError(f"the sharded NTT and iNTT launched (got, planned) {wrong}")
    if not torch.equal(mesh.gather(evals), want_evals):
        raise AssertionError("the sharded NTT differs from the single-device K-b ntt")
    if not torch.equal(mesh.gather(back), column):
        raise AssertionError("the sharded iNTT does not return the column")
    if M.points_from_device(got_msm[None])[0] != want_msm:
        raise AssertionError("the sharded MSM differs from ops/msm.msm and the host's")
    if M.points_from_device(commits) != want_commits:
        raise AssertionError("batch_commit differs from the serial commitments")
    if runs[0] != batch["proofs"] or runs[1] != batch["proofs"]:
        raise AssertionError("the sharded batch's bytes differ from phase 7's unsharded batch")
    if not all(verify_proof(srs, vk, p) for p in runs[0]):
        raise AssertionError("a sharded delay_enc proof does not verify")
    never = [name for name in ("shard_stages", "shard_reshuffle", "ntt_fused", "plane_sums",
                               "g1_complete_add", "pair_sel") if launches[name] == 0]
    if never:
        raise AssertionError(f"the mesh's path never launched {never}")
    ms = {name: wall_ms(fn, 20) for name, fn in (
        ("sharded ntt", lambda: sharded_ntt(mesh, plan, column)),
        ("sharded intt", lambda: sharded_intt(mesh, plan, evals)),
        ("single ntt", lambda: N.ntt(single, column)),
        ("single intt", lambda: N.intt(single, want_evals)))}
    print(f"phase 9 sharded NTT k={k} over {d} shards (L=2^{k - m}): NTT and iNTT equal the "
          f"single-device K-b ntt and intt; launches {json.dumps(want_ntt)} and no other "
          f"(one stages, one K-b call over the card's stack and one reshuffle a card and "
          f"direction; every twiddle and 1/N in the stages kernel); host ms a call, every card "
          f"waited for, 20 calls: {json.dumps({key: round(v, 6) for key, v in ms.items()})} "
          f"(the kernels read the blocks {where})", flush=True)
    print(f"phase 9 sharded MSM of 2^{k} SRS points: equal to ops/msm.msm and the host's C MSM; "
          f"batch_commit of {BATCH} x 2^{k}: equal to the serial commitments", flush=True)
    rate = lambda wall: BATCH / wall
    print(f"phase 9 batch delay_enc k={k} B={BATCH} over {d} shards on {card}: "
          f"create_proofs_batched(mesh=) {walls[0]:.3f} s then {walls[1]:.3f} s "
          f"({rate(walls[0]):.4f} then {rate(walls[1]):.4f} proofs/s), peak device memory of "
          f"the phase {peak / 2**30:.3f} GiB (the fullest card); phase 7's unsharded batch {batch['walls'][0]:.3f} "
          f"s then {batch['walls'][1]:.3f} s ({rate(batch['walls'][0]):.4f} then "
          f"{rate(batch['walls'][1]):.4f} proofs/s), peak {batch['peak'] / 2**30:.3f} GiB; "
          f"the bytes equal phase 7's, all {BATCH} verify; the phase's launches "
          f"{json.dumps(launches)}", flush=True)

    def run():
        if create_proofs_batched(srs, pk, batch["builders"], np.random.default_rng(0), mesh=mesh,
                                 axis=mesh.axis) != batch["proofs"]:
            raise AssertionError("the profiled sharded batch differs")

    profile_run(run, "phase 9", f"batch of {BATCH} over {d} shards")

    srs7, pk7, vk7 = k7
    mesh2, kind2 = mesh_of(2)
    with np.load(os.path.join(ROOT, "tests", "data", "torch_port_batch_k7.npz")) as z:
        builders = [k7_circuit(*(int(v) for v in w)) for w in z["witnesses"]]
        want, seed = [p.tobytes() for p in z["proofs"]], int(z["seed"])
    for msm in ("b4", "b16"):
        if create_proofs_batched(srs7, pk7, builders, np.random.default_rng(seed), msm=msm,
                                 mesh=mesh2, axis=mesh2.axis) != want:
            raise AssertionError(f"the sharded k=7 batch ({msm}) differs from the JAX package's")
    print(f"phase 9 batched k=7 over 2 shards ({kind2}): both MSM bases equal the JAX "
          f"package's batch", flush=True)
    t0 = time.time()
    dryrun_multichip(d, devices=mesh.devices)
    print(f"phase 9 dryrun_multichip({d}, fast=False): ok in {time.time() - t0:.3f} s", flush=True)
    return launches


def mod_pow_phase(dev, card: str) -> None:
    """mod_pow at k=17, bench.py's draw: SRS setup, keygen, two proofs from
    one rng seed that must be byte-identical, verify; the launch counts are
    set to 0 just before and read just after."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime.workloads import build_circuit
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    GLOBAL_METRICS.clear()
    k = 17
    t0 = time.time()
    b = build_circuit("mod_pow", k)
    t_build = time.time() - t0
    if min_k(b) > k:
        raise AssertionError(f"mod_pow needs k={min_k(b)}")
    _cuda.reset_launches()
    t0 = time.time()
    srs = SRS.setup(k, tau=0x5EED_0F_0D90, device=dev)
    t_srs = time.time() - t0
    t0 = time.time()
    pk, vk = keygen(b, srs, k=k, device=dev)
    t_key = time.time() - t0
    vk_parity("phase 5", "mod_pow", b, vk, "b4", t_key)
    before = _cuda.launch_counts()
    proofs, t_prove = [], []
    for _ in range(2):
        t0 = time.time()
        proofs.append(create_proof(srs, pk, b, np.random.default_rng(0), device=dev))
        torch.cuda.synchronize()
        t_prove.append(time.time() - t0)
    launches = _cuda.launch_counts()
    proof_launches = {name: (launches[name] - before[name]) // 2 for name in launches}
    if proofs[0] != proofs[1]:
        raise AssertionError("mod_pow proofs from one rng seed differ")
    t0 = time.time()
    if not verify_proof(srs, vk, proofs[0]):
        raise AssertionError("mod_pow proof does not verify")
    t_ver = time.time() - t0
    print(f"phase 5 mod_pow k={k} on {card}: rows={b.rows} circuit build {t_build:.3f} s (host), "
          f"SRS setup {t_srs:.3f} s, keygen {t_key:.3f} s, prove {t_prove[0]:.3f} s then "
          f"{t_prove[1]:.3f} s (identical bytes), verify {t_ver:.3f} s (host), proof "
          f"{len(proofs[0])} B, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; spans {json.dumps(spans())}; "
          f"launches {json.dumps(launches)}; a proof's {json.dumps(proof_launches)}", flush=True)
    if launches["g1_fixed_base_mul"] != 1 or launches["g1_complete_add"] != 3:
        raise AssertionError(f"SRS setup and pair tables launched {launches}")
    check_proof_launches(proof_launches, k)
    profile_proof(srs, pk, b, proofs[0], dev, "phase 5")
    mxu_proof_phase(dev, card, srs, pk, b, proofs[0], "phase 5")
    del pk
    vk_parity_b16("phase 5", "mod_pow", b, srs, k, dev)


def split_proofs(dev, card: str, phase: str, workload: str, k: int, tau: int) -> tuple:
    """bench.py's row of `workload` at k (its T_BITS, nothing cut): SRS setup
    at k and keygen(k=k), which must pick the split quotient; two proofs from
    one rng seed that must be byte-identical and verify, their launches held
    to the split plan; one more under the profiler.  Returns (circuit, srs,
    pk, vk, proof, peak device memory over the two proofs, the launch counts
    set to 0 just before the SRS setup and read just after the two
    proofs)."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime.workloads import T_BITS, build_circuit
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    torch.cuda.empty_cache()
    GLOBAL_METRICS.clear()
    t0 = time.time()
    b = build_circuit(workload, k)
    t_build = time.time() - t0
    if min_k(b) > k:
        raise AssertionError(f"{workload} for k={k} needs k={min_k(b)}")
    _cuda.reset_launches()
    t0 = time.time()
    srs = SRS.setup(k, tau=tau, device=dev)
    t_srs = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pk, vk = keygen(b, srs, k=k, device=dev)
    torch.cuda.synchronize()
    t_key = time.time() - t0
    if not pk.split or pk.ext_stack is not None:
        raise AssertionError(f"keygen at k={k} did not pick the split quotient")
    key_spans, key_peak = spans("keygen/"), torch.cuda.max_memory_allocated()
    vk_parity(phase, workload, b, vk, "b4", t_key)
    launches = _cuda.launch_counts()
    proofs, t_prove, prove_spans, proved = [], [], [], dict.fromkeys(launches, 0)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        GLOBAL_METRICS.clear()  # the spans and the launch counts
        t0 = time.time()
        proofs.append(create_proof(srs, pk, b, np.random.default_rng(0), device=dev))
        torch.cuda.synchronize()
        t_prove.append(time.time() - t0)
        prove_spans.append(spans("prove/"))
        for name, n in _cuda.launch_counts().items():
            proved[name] += n
    split_peak = torch.cuda.max_memory_allocated()
    launches = {name: launches[name] + n for name, n in proved.items()}
    proof_launches = {name: n // 2 for name, n in proved.items()}
    if proofs[0] != proofs[1]:
        raise AssertionError(f"{workload} k={k} split proofs from one rng seed differ")
    t0 = time.time()
    if not verify_proof(srs, vk, proofs[0]):
        raise AssertionError(f"{workload} k={k} split proof does not verify")
    t_ver = time.time() - t0
    print(f"{phase} {workload} k={k} split on {card}: T_BITS {T_BITS[(workload, k)]}, "
          f"rows={b.rows} (min_k {min_k(b)}) circuit build {t_build:.3f} s (host), SRS setup "
          f"{t_srs:.3f} s, keygen {t_key:.3f} s (split picked; peak device memory "
          f"{key_peak / 2**30:.3f} GiB), prove {t_prove[0]:.3f} s then {t_prove[1]:.3f} s "
          f"(identical bytes), verify {t_ver:.3f} s (host), proof {len(proofs[0])} B, peak "
          f"device memory over the two proofs {split_peak / 2**30:.3f} GiB; keygen spans "
          f"{json.dumps(key_spans)}; a proof's spans {json.dumps(prove_spans)}; launches "
          f"{json.dumps(launches)}; a proof's {json.dumps(proof_launches)}", flush=True)
    if launches["g1_fixed_base_mul"] != 1 or launches["g1_complete_add"] != 3:
        raise AssertionError(f"SRS setup and pair tables launched {launches}")
    check_proof_launches(proof_launches, k, split=True)
    profile_proof(srs, pk, b, proofs[0], dev, f"{phase} {workload} k={k} split")
    return b, srs, pk, vk, proofs[0], split_peak, launches


def delay_enc_split_phase(dev, card: str, k: int = 18) -> dict:
    """delay_enc at k=18, bench.py's draw (|T| = 31), whose circuit needs
    k=18: `split_proofs`; then a fused keygen (split=False) on the same SRS
    and circuit that must give the same vk, and one fused proof that must
    equal the split proofs, with its peak device memory beside theirs.
    Returns the launch counts of the split run."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import create_proof, keygen
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    b, srs, pk, vk, proof, split_peak, launches = split_proofs(
        dev, card, "phase 6", "delay_enc", k, 0x5EED_0F_DE1A7_18)
    if min_k(b) != k:
        raise AssertionError(f"delay_enc for k={k} needs k={min_k(b)}")
    try:
        create_proof(srs, pk, b, np.random.default_rng(0), device=dev, ntt="mxu")
    except ValueError as e:
        print(f"phase 6 split key with ntt='mxu': ValueError, as it must ({e})", flush=True)
    else:
        raise AssertionError("a split key proved with ntt='mxu'")

    # the fused path on the same SRS and circuit: the same vk, the same bytes
    del pk
    torch.cuda.empty_cache()
    GLOBAL_METRICS.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pk_f, vk_f = keygen(b, srs, split=False, device=dev)
    torch.cuda.synchronize()
    t_key_f = time.time() - t0
    if pk_f.split:
        raise AssertionError("keygen(split=False) built a split key")
    check_vk(vk_f, vk, f"keygen(split=False) at k={k}")
    key_f_spans, key_f_peak = spans("keygen/"), torch.cuda.max_memory_allocated()
    GLOBAL_METRICS.clear()
    torch.cuda.reset_peak_memory_stats()
    before = _cuda.launch_counts()
    t0 = time.time()
    proof_f = create_proof(srs, pk_f, b, np.random.default_rng(0), device=dev)
    torch.cuda.synchronize()
    t_fused = time.time() - t0
    fused_peak = torch.cuda.max_memory_allocated()
    after = _cuda.launch_counts()
    if proof_f != proof:
        raise AssertionError(f"the delay_enc k={k} fused proof differs from the split proofs")
    print(f"phase 6 delay_enc k={k} fused: keygen {t_key_f:.3f} s (peak device memory "
          f"{key_f_peak / 2**30:.3f} GiB), the split key's vk; prove {t_fused:.3f} s, the split "
          f"proofs' bytes; peak device memory over the proof {fused_peak / 2**30:.3f} GiB "
          f"against split {split_peak / 2**30:.3f} GiB; keygen spans {json.dumps(key_f_spans)}; "
          f"spans {json.dumps(spans('prove/'))}", flush=True)
    check_proof_launches({name: after[name] - before[name] for name in after}, k)
    profile_proof(srs, pk_f, b, proof_f, dev, "phase 6 fused")
    del pk_f
    torch.cuda.empty_cache()
    vk_parity_b16("phase 6", "delay_enc", b, srs, k, dev)
    del srs
    return launches


LARGEST_ROWS = (("delay_enc", 19, 0x5EED_0F_DE1A7_19), ("mod_pow", 19, 0x5EED_0F_0D90_19))


def largest_rows_phase(dev, card: str, workload: str, k: int, tau: int) -> dict:
    """bench.py's largest row of `workload`: `split_proofs` at k; for
    delay_enc the base-16 table (seconds, K-d launches, bytes) and one
    msm="b16" proof with the base-4 bytes, its peak beside the split
    proofs'.  Returns the launch counts of the split run."""
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import create_proof

    t_phase = time.time()
    b, srs, pk, vk, proof, split_peak, launches = split_proofs(
        dev, card, "phase 10", workload, k, tau)
    del vk

    if workload == "delay_enc":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _cuda.launch_counts()
        t0 = time.time()
        tab = srs.pair_tables16()
        torch.cuda.synchronize()
        t_tab = time.time() - t0
        tab_peak = torch.cuda.max_memory_allocated()
        table_launches = {name: n - before[name] for name, n in _cuda.launch_counts().items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof_b16 = create_proof(srs, pk, b, np.random.default_rng(0), device=dev, msm="b16")
        torch.cuda.synchronize()
        t_b16 = time.time() - t0
        b16_peak = torch.cuda.max_memory_allocated()
        if proof_b16 != proof:
            raise AssertionError(f"the {workload} k={k} proof with msm='b16' differs from base 4")
        print(f"phase 10 {workload} k={k} msm='b16': table {t_tab:.3f} s, "
              f"{table_launches['g1_complete_add']} K-d launches, {tab.numel() * 4} bytes, peak "
              f"device memory while it is built {tab_peak / 2**30:.3f} GiB; prove {t_b16:.3f} s, "
              f"the base-4 bytes; peak device memory over the proof {b16_peak / 2**30:.3f} GiB "
              f"(table resident) against base 4 {split_peak / 2**30:.3f} GiB", flush=True)
        if table_launches["g1_complete_add"] != 15 or sum(table_launches.values()) != 15:
            raise AssertionError(f"the base-16 table launched {table_launches}")
        # what a disk cache of the table would pay after reading its file: the
        # copy into the card from pinned host memory, its best case
        host = torch.empty(tab.shape, dtype=tab.dtype, pin_memory=True)
        host.copy_(tab)
        back = torch.empty_like(tab)
        torch.cuda.synchronize()
        t0 = time.time()
        back.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        t_copy = time.time() - t0
        if not torch.equal(back, tab):
            raise AssertionError("the base-16 table copied in from the host differs")
        print(f"phase 10 {workload} k={k} msm='b16' table from pinned host memory: "
              f"{tab.numel() * 4} bytes in {t_copy:.4f} s ({tab.numel() * 4 / t_copy / 1e9:.2f} "
              f"GB/s) against its build's {t_tab:.4f} s", flush=True)
        del tab, host, back
    del pk, srs
    torch.cuda.empty_cache()
    log(f"  phase 10 {workload} k={k}: {time.time() - t_phase:.1f} s")
    return launches


DAEMON_SEED = 7  # the rng seed of phase 8's fixed-seed requests
# the split quotient's (k >= 18 only) and the mesh's: the daemon proves on one device
DAEMON_OFF_PATH = ("quotient_h_coset", "shard_stages", "shard_reshuffle")
DAEMON_WAIT_S = 600  # the most that phase 8 waits for one warm entry


def _daemon_log(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def _selfcheck_lines(lines: list) -> tuple:
    """(ok, MISMATCH) counts of the `# selfcheck` lines of a daemon log."""
    sc = [ln for ln in lines if ln.startswith("# selfcheck ")]
    return sum(ln.endswith(": ok") for ln in sc), sum("MISMATCH" in ln for ln in sc)


def daemon_phase(dev, card: str) -> dict:
    """The warm prover daemon on the card (runtime/daemon.py), as a user runs
    it, in a fresh temporary directory D that holds its socket, SRS files,
    key cache and log: pose_enc:11 warmed with the commitment selfcheck (29
    ok, no MISMATCH), a selfcheck-2 request (the GWC witnesses too); then,
    with selfcheck 0 set, delay_enc:16 and batch:16:4 warmed while a
    pose_enc:11 request is served (the idle-served bytes); delay_enc:16 with
    3 repeats in base 4 and in base 16 (the same bytes), and 2 with
    DELAY_ENC_NTT=mxu in the request's env (the same bytes); the batch of 4 with
    2 repeats; shutdown, exit 0; then the daemon's SRS and key files read back
    in this process (SRS.load, get_keys, load_vk) prove the served bytes,
    and keygen on that SRS gives the file's vk.  Every kernel of the path
    but the split quotient's must have launched in the daemon.  Returns the
    daemon's launch counts (from its start, read before shutdown) plus this
    process's reload run's (set to 0 just before it)."""
    import shutil
    import tempfile

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.serialize import load_vk
    from delay_enc_tpu_torch.runtime import daemon_request
    from delay_enc_tpu_torch.runtime import workloads as W
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="daemon_")
    sock, err_path = os.path.join(d, "d.sock"), os.path.join(d, "daemon.log")
    if len(sock.encode()) > 100:
        raise AssertionError(f"the socket path {sock} is too long for AF_UNIX")

    def req(r: dict, timeout: float = 900.0, events=None) -> dict:
        got = daemon_request(r, on_event=None if events is None else events.append,
                             timeout=timeout, socket_path=sock)
        if got is None:
            raise AssertionError(f"no answer from the daemon to {r.get('cmd')}")
        if got.get("event") == "error":
            raise AssertionError(f"the daemon failed {r}: {got.get('error')}")
        return got

    def wait_warm(keys) -> dict:
        deadline = time.time() + DAEMON_WAIT_S
        while True:
            st = daemon_request({"cmd": "ping"}, socket_path=sock)
            if proc.poll() is not None:
                raise AssertionError(f"the daemon exited with {proc.returncode}")
            if st and st["failed_warm"]:
                raise AssertionError(f"the daemon's warm failed: {st['failed_warm']}")
            if st and all(k in st["warm"] for k in keys):
                return st
            if time.time() > deadline:
                raise AssertionError(f"the daemon never warmed {keys}: {st}")
            time.sleep(0.2)

    def prove(workload: str, k: int, repeats: int = 1, **extra) -> dict:
        evs = []
        fin = req({"cmd": "prove", "workload": workload, "k": k, "repeats": repeats,
                   "seed": DAEMON_SEED, "budget_s": 900, **extra}, events=evs)
        if fin["verified"] is not True:
            raise AssertionError(f"a served {workload}:{k} proof does not verify")
        fin["spans"] = evs[-1]["phases_s"]
        return fin

    t_start = time.time()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "delay_enc_tpu_torch.runtime.daemon", "--warm", "pose_enc:11",
             "--socket", sock, "--srs-dir", d, "--key-dir", d],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
    try:
        # ---- pose_enc:11: the warmup's commitment selfcheck, then level 2
        st = wait_warm(["pose_enc:11"])
        ok, bad = _selfcheck_lines(_daemon_log(err_path))
        if (ok, bad) != (29, 0) or st["warm_selfcheck"]["pose_enc:11"]["ok"] != 29:
            raise AssertionError(f"the pose_enc:11 warmup's selfcheck: {ok} ok, {bad} MISMATCH")
        t_warm11 = time.time() - t_start
        sc2 = prove("pose_enc", 11, env={"DELAY_ENC_SELFCHECK": "2"})
        ok, bad = _selfcheck_lines(_daemon_log(err_path))
        gwc = sum(ln.startswith("# selfcheck gwc ") and ln.endswith(": ok")
                  for ln in _daemon_log(err_path))
        if (ok, bad, gwc) != (29 + 32, 0, 3) or sc2["selfcheck"]["mismatch"]:
            raise AssertionError(f"the selfcheck-2 request: {ok} ok, {bad} MISMATCH, {gwc} gwc ok")
        idle = prove("pose_enc", 11)
        # ---- the k=16 entries warm while pose_enc:11 is served
        req({"cmd": "setenv", "env": {"DELAY_ENC_SELFCHECK": "0"}})
        req({"cmd": "set_warm", "warm": "delay_enc:16,batch:16:4"})
        while True:
            st = req({"cmd": "ping"})
            if st["warming"] == "delay_enc:16":
                break
            if "delay_enc:16" in st["warm"] or st["failed_warm"]:
                raise AssertionError(f"delay_enc:16 was not seen warming: {st}")
            time.sleep(0.05)
        during = prove("pose_enc", 11)
        st = req({"cmd": "ping"})
        if "delay_enc:16" in st["warm"]:
            raise AssertionError("the pose_enc:11 request was not served while delay_enc:16 warmed")
        if during["proof_hex"] != idle["proof_hex"]:
            raise AssertionError("pose_enc:11 served during a warm differs from the idle-served proof")
        st = wait_warm(["delay_enc:16", "batch:16:4"])
        if _selfcheck_lines(_daemon_log(err_path))[0] != 29 + 32:
            raise AssertionError("a selfcheck ran after DELAY_ENC_SELFCHECK=0 was set")
        # ---- delay_enc:16 in both MSM bases, then the batch
        b4 = prove("delay_enc", 16, repeats=3)
        req({"cmd": "setenv", "env": {"DELAY_ENC_MSM": "b16"}})
        b16 = prove("delay_enc", 16, repeats=3)
        if b16["msm"] != "b16" or b16["proof_hex"] != b4["proof_hex"]:
            raise AssertionError("the delay_enc:16 proof served in base 16 differs from base 4's")
        req({"cmd": "setenv", "env": {"DELAY_ENC_MSM": None}})
        mxu = prove("delay_enc", 16, repeats=2, env={"DELAY_ENC_NTT": "mxu"})
        if mxu["ntt"] != "mxu" or mxu["proof_hex"] != b4["proof_hex"]:
            raise AssertionError("the delay_enc:16 proof served with DELAY_ENC_NTT=mxu differs "
                                 "from K-b's")
        evs = []
        batch = req({"cmd": "batch", "k": 16, "b": BATCH, "repeats": 2, "budget_s": 900},
                    events=evs)
        if batch["verified"] is not True or batch["msm"] != "b4":
            raise AssertionError("the served batch of 4 does not verify")
        st = req({"cmd": "ping"})
        req({"cmd": "shutdown"})
        rc = proc.wait(120)
        if rc != 0:
            raise AssertionError(f"the daemon exited with {rc}")
        t_daemon = time.time() - t_start
        log_lines = _daemon_log(err_path)

        # ---- the daemon's files, read back here
        GLOBAL_METRICS.clear()
        _cuda.reset_launches()
        srs = SRS.load(os.path.join(d, "srs_bn254_k16.npz"), device=dev)
        b = W.build_circuit("delay_enc", 16)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pk, vk, path = W.get_keys("delay_enc", b, srs, 16, d, device=dev)
        t_load = time.time() - t0
        if "keys/load_pk" not in GLOBAL_METRICS.snapshot():
            raise AssertionError("get_keys did not find the daemon's key")
        key_bytes = os.path.getsize(path + ".pk.npz")
        t0 = time.time()
        proof = create_proof(srs, pk, b, np.random.default_rng(DAEMON_SEED), device=dev)
        t_local = time.time() - t0
        if proof.hex() != b4["proof_hex"] or not verify_proof(srs, vk, proof):
            raise AssertionError("the proof from the daemon's SRS and key files differs from the "
                                 "served one")
        if load_vk(path + ".vk.npz").transcript_repr != vk.transcript_repr:
            raise AssertionError("load_vk of the daemon's vk file gives another transcript_repr")
        t0 = time.time()
        _, vk_again = keygen(b, srs, k=16, device=dev)
        t_key = time.time() - t0
        if vk_again.transcript_repr != vk.transcript_repr:
            raise AssertionError("keygen on the daemon's SRS gives another vk than its key file")
        reload_launches = _cuda.launch_counts()
        del pk, srs
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(d, ignore_errors=True)
    for line in log_lines:
        if line.startswith("# daemon") or line.startswith("# keys"):
            log(f"  {line}")
    warm_spans = st["warm_spans"]
    print(f"phase 8 daemon on {card}: {t_daemon:.3f} s from start to exit 0; warm seconds "
          f"{json.dumps({k: round(v, 3) for k, v in st['warm_s'].items()})} (pose_enc:11 "
          f"answered ping {t_warm11:.3f} s after the start); warm spans {json.dumps(warm_spans)}; "
          f"peak device memory {st['device_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    de16 = warm_spans["delay_enc:16"]
    print(f"phase 8 files k=16: keygen {de16['keys/keygen']:.3f} s and save_pk "
          f"{de16['keys/save_pk']:.3f} s in the daemon, load_pk {warm_spans['batch:16:4']['keys/load_pk']:.3f} s "
          f"there (batch:16:4) and {t_load:.3f} s here (get_keys, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB); the key file "
          f"{key_bytes} bytes; in-process keygen {t_key:.3f} s gives the file's vk; the "
          f"in-process proof ({t_local:.4f} s, the first on this key) equals the served one",
          flush=True)
    print(f"phase 8 selfcheck pose_enc k=11: warmup (level 1, 29 commitments ok) "
          f"{warm_spans['pose_enc:11']['warm/proof']:.3f} s of warmup proof; level 2 request "
          f"{sc2['best_s']:.3f} s (32 ok) against {idle['best_s']:.3f} s without: "
          f"{sc2['best_s'] - idle['best_s']:.3f} s for the checks", flush=True)
    for name, fin in (("pose_enc:11 idle", idle), ("pose_enc:11 during the k=16 warm", during),
                      ("delay_enc:16 b4", b4), ("delay_enc:16 b16", b16),
                      ("delay_enc:16 DELAY_ENC_NTT=mxu", mxu)):
        print(f"phase 8 served {name}: best_s {fin['best_s']:.4f} of {fin['repeats']}, verified; "
              f"last repeat's spans {json.dumps(fin['spans'])}", flush=True)
    print(f"phase 8 served batch k=16 B={batch['b']}: best_s {batch['best_s']:.4f} of "
          f"{batch['repeats']}, {batch['proofs_per_s']:.4f} proofs/s, verified; repeats "
          f"{json.dumps([(e['seconds'], e['proofs_per_s']) for e in evs])}; last repeat's spans "
          f"{json.dumps(evs[-1]['phases_s'])}", flush=True)
    print(f"phase 8 launches: the daemon's {json.dumps(st['launches'])}; the reload's "
          f"{json.dumps(reload_launches)}", flush=True)
    idle = [name for name, n in st["launches"].items()
            if n == 0 and name not in NOT_ON_PROOF + DAEMON_OFF_PATH]
    if idle:
        raise AssertionError(f"kernels the daemon's path never launched: {idle}")
    return {name: st["launches"].get(name, 0) + reload_launches.get(name, 0)
            for name in reload_launches}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the card only")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"phase 0 card: {card}", flush=True)

    # the host path: the C libraries behind to_mont, lookup_fvals, the plane
    # folds and the verifier, which must not fall back to Python on the card
    from delay_enc_tpu_torch import native

    t0 = time.time()
    libs = native.status()
    print("phase 0 host C libraries: " + ", ".join(
        f"{name} {'loaded from ' + os.path.relpath(path, ROOT) if path else 'NOT loaded'}"
        for name, path in libs.items()) + f" ({time.time() - t0:.2f} s)", flush=True)
    native.require()

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, load_vk, min_k
    from delay_enc_tpu_torch.runtime.workloads import build_circuit
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    t0 = time.time()
    _cuda.build(force=True)
    print(f"phase 0 build: {time.time() - t0:.2f} s for {len(_cuda.SOURCES)} sources", flush=True)
    for name in _cuda.SOURCES:
        with open(os.path.join(_cuda.BUILD, f"{name}.log")) as f:
            for line in f:
                if "Compiling entry" in line:
                    log(f"  {name}: {line.split(chr(39))[1]}")
                elif any(w in line for w in ("registers", "spill", "arning", "Performance Loss")):
                    log(f"  {name}:   {line.strip()}")

    k7 = golden_k7(dev)
    batch_k7(dev, *k7)

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = sm_count * INT_PER_SM_CLK * clock_mhz * 1e6
    tc_rate = sm_count * TC_INT8_PER_SM_CLK * clock_mhz * 1e6
    log(f"integer rate: {sm_count} SMs x {INT_PER_SM_CLK} x {clock_mhz} MHz = {int_rate:.4g}/s; "
        f"int8 tensor-core rate {sm_count} x {TC_INT8_PER_SM_CLK} x {clock_mhz} MHz = "
        f"{tc_rate:.4g}/s")
    rep = Report(int_rate, tc_rate)
    phase1(rep, dev)
    pow_launches = field_pow_path(dev)
    torch.cuda.empty_cache()

    # ---- 2. artefacts of the JAX package ------------------------------
    t0 = time.time()
    srs11 = SRS.load(os.path.join(DATA, "srs_bn254_k11.npz"), device=dev)
    b11 = build_circuit("pose_enc")
    k11 = max(min_k(b11), 11)
    pk11, vk11 = keygen(b11, srs11, k=k11, device=dev)
    want = load_vk(os.path.join(DATA, VK_FILE))
    if k11 != want.domain.k:
        raise AssertionError(f"pose_enc k={k11}, committed vk k={want.domain.k}")
    check_vk(vk11, want, "keygen")
    with open(os.path.join(DATA, "proof_pose_enc_k11.bin"), "rb") as f:
        jax_proof = f.read()
    if not verify_proof(SRS.load_host_meta(os.path.join(DATA, "srs_bn254_k11.npz")), want,
                        jax_proof):
        raise AssertionError("the committed JAX proof does not verify")
    print(f"phase 2 artefacts: keygen reproduces the committed vk "
          f"({len(ALL_FIXED)} fixed + {len(want.sigma_commitments)} sigma), "
          f"committed proof verifies ({time.time() - t0:.2f} s)", flush=True)

    # ---- 3. pose_enc k=11 ---------------------------------------------
    GLOBAL_METRICS.clear()
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
    with np.load(os.path.join(ROOT, "tests", "data", "torch_port_k11.npz")) as z:
        if int(z["seed"]) != 0 or proofs[0] != z["proof"].tobytes():
            raise AssertionError("the pose_enc k=11 proof differs from the JAX package's "
                                 "(tests/data/torch_port_k11.npz)")
    t0 = time.time()
    if not verify_proof(srs11, vk11, proofs[0]):
        raise AssertionError("pose_enc proof does not verify")
    t_ver = time.time() - t0
    print(f"phase 3 pose_enc k={k11}: rows={b11.rows} keygen {t_key:.3f} s, prove "
          f"{t_prove[0]:.3f} s then {t_prove[1]:.3f} s (identical bytes, the JAX package's "
          f"proof's), verify {t_ver:.3f} s, proof {len(proofs[0])} B; spans "
          f"{json.dumps(spans())}", flush=True)
    # the base-16 MSM: an MSM has one answer, so the vk and the proof bytes
    # are the base-4 ones
    t0 = time.time()
    tab11 = srs11.pair_tables16()
    torch.cuda.synchronize()
    t_tab = time.time() - t0
    t0 = time.time()
    pk11, vk11 = keygen(b11, srs11, k=k11, device=dev, msm="b16")
    t_key = time.time() - t0
    check_vk(vk11, want, "keygen with msm='b16'")
    t0 = time.time()
    proof_b16 = create_proof(srs11, pk11, b11, np.random.default_rng(0), device=dev, msm="b16")
    torch.cuda.synchronize()
    t_b16 = time.time() - t0
    if proof_b16 != proofs[0]:
        raise AssertionError("the pose_enc proof with msm='b16' differs from the base-4 proof")
    print(f"phase 3 pose_enc k={k11} msm='b16': table {t_tab:.3f} s, {tab11.numel() * 4} bytes; "
          f"keygen {t_key:.3f} s reproduces the committed vk; prove {t_b16:.3f} s, the base-4 "
          f"proof's bytes and the JAX package's", flush=True)
    del pk11, srs11, tab11

    # ---- 4. delay_enc k=16, the main path -----------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    GLOBAL_METRICS.clear()
    t0 = time.time()
    b16 = build_circuit("delay_enc", 16)
    t_build = time.time() - t0
    k16 = max(min_k(b16), 16)
    _cuda.reset_launches()
    t0 = time.time()
    srs16 = SRS.setup(k16, tau=0x5EED_0F_DE1A7, device=dev)
    t_srs = time.time() - t0
    t0 = time.time()
    pk16, vk16 = keygen(b16, srs16, k=k16, device=dev)
    t_key = time.time() - t0
    vk_parity("phase 4", "delay_enc", b16, vk16, "b4", t_key)
    before = _cuda.launch_counts()
    t0 = time.time()
    proof16 = create_proof(srs16, pk16, b16, np.random.default_rng(0), device=dev)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    launches = _cuda.launch_counts()
    proof_launches = {name: launches[name] - before[name] for name in launches}
    t0 = time.time()
    ok = verify_proof(srs16, vk16, proof16)
    t_ver = time.time() - t0
    if not ok:
        raise AssertionError("delay_enc proof does not verify")
    print(f"phase 4 delay_enc k={k16}: rows={b16.rows} circuit build {t_build:.3f} s (host), "
          f"SRS setup {t_srs:.3f} s, keygen {t_key:.3f} s, prove {t_prove:.3f} s, "
          f"verify {t_ver:.3f} s (host), proof {len(proof16)} B, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; spans {json.dumps(spans())}; "
          f"launches {json.dumps(launches)}; of them the proof's {json.dumps(proof_launches)}",
          flush=True)

    # the SRS powers are one launch of the fused kernel, and the elementwise
    # addition is left with the three launches of pair_tables
    if launches["g1_fixed_base_mul"] != 1 or launches["g1_complete_add"] != 3:
        raise AssertionError(f"SRS setup and pair tables launched {launches}")

    check_proof_launches(proof_launches, k16)

    profile_proof(srs16, pk16, b16, proof16, dev, "phase 4")

    # ---- 4, ntt="mxu": every transform through K11 ------------------------
    mxu_launches = mxu_proof_phase(dev, card, srs16, pk16, b16, proof16, "phase 4")

    # ---- 7. the batched and pipelined provers on phase 4's SRS and key ----
    batch = batch_phase(dev, card, srs16, pk16, vk16)
    batch_launches = batch["launches"]

    # ---- 9. the mesh, on phase 4's SRS and key and phase 7's batch --------
    mesh_launches = mesh_phase(dev, card, srs16, pk16, vk16, k7, batch)
    del batch

    # ---- 4, base 16: the same SRS and keys through the base-16 MSM ------
    torch.cuda.reset_peak_memory_stats()
    GLOBAL_METRICS.clear()
    _cuda.reset_launches()
    t0 = time.time()
    tab16 = srs16.pair_tables16()
    torch.cuda.synchronize()
    t_tab = time.time() - t0
    table_launches = _cuda.launch_counts()
    t0 = time.time()
    proof_b16 = create_proof(srs16, pk16, b16, np.random.default_rng(0), device=dev, msm="b16")
    torch.cuda.synchronize()
    t_b16 = time.time() - t0
    b16_launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    b16_spans = spans()
    if proof_b16 != proof16:
        raise AssertionError("the delay_enc proof with msm='b16' differs from the base-4 proof")
    t0 = time.time()
    if create_proof(srs16, pk16, b16, np.random.default_rng(0), device=dev) != proof16:
        raise AssertionError("a second base-4 delay_enc proof differs from the first")
    torch.cuda.synchronize()
    t_b4 = time.time() - t0
    print(f"phase 4 delay_enc k={k16} msm='b16': table {t_tab:.3f} s, "
          f"{table_launches['g1_complete_add']} K-d launches, {tab16.numel() * 4} bytes; prove "
          f"{t_b16:.3f} s (the base-4 proof's bytes) against base 4 {t_prove:.3f} s before it "
          f"and {t_b4:.3f} s after it; peak device memory {peak / 2**30:.3f} GiB; spans "
          f"{json.dumps(b16_spans)}; launches {json.dumps(b16_launches)}", flush=True)
    if table_launches["g1_complete_add"] != 15 or sum(table_launches.values()) != 15:
        raise AssertionError(f"the base-16 table launched {table_launches}")
    check_proof_launches({name: b16_launches[name] - table_launches[name] for name in b16_launches},
                         k16, msm="b16")
    groups = profile_proof(srs16, pk16, b16, proof16, dev, "phase 4 msm='b16'",
                           msm="b16")["by_kernel"]
    if groups and ("plane_sums16" not in groups or "plane_sums (K-c)" in groups):
        raise AssertionError(f"the profiled b16 proof ran {sorted(groups)}")
    del pk16
    vk_parity_b16("phase 4", "delay_enc", b16, srs16, k16, dev)
    del srs16, b16, tab16

    # ---- 5. mod_pow k=17 ----------------------------------------------
    mod_pow_phase(dev, card)

    # ---- 6. delay_enc k=18, the split quotient --------------------------
    split_launches = delay_enc_split_phase(dev, card)

    # ---- 10. the largest rows of bench.py's sweep ------------------------
    largest_launches = [largest_rows_phase(dev, card, *row) for row in LARGEST_ROWS]

    # ---- 8. the warm prover daemon ---------------------------------------
    daemon_launches = daemon_phase(dev, card)

    # ---- kernels --------------------------------------------------------
    for name, row in rep.rows.items():
        row["launches"] = sum(run.get(name, 0)
                              for run in (launches, b16_launches, split_launches, batch_launches,
                                          daemon_launches, mesh_launches, mxu_launches,
                                          pow_launches, *largest_launches))
    # K5 and K6 took the last subtractions of a proof, K7 the last sums (0
    # launches, asserted): K-a's subtraction and sum are checked in phase 1
    # but are no kernels of the path.
    for name in OFF_PATH:
        row = rep.rows.pop(name)
        print(f"phase 4 {name}: off the main path, {row['launches']} launches; phase 1 "
              f"max_abs_err={row['max_abs_err']} kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms", flush=True)
    missing = [name for name, row in rep.rows.items() if row["launches"] == 0]
    print(json.dumps({"kernels": list(rep.rows.values())}), flush=True)
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # the lookup keys of the proofs since the counters were last cleared,
    # every one read by the C reader
    readers = {k: GLOBAL_METRICS.counters.get(k, 0)
               for k in ("permute native", "permute python", "to_mont native", "to_mont python")}
    print("host readers: " + ", ".join(f"{k} {v}" for k, v in readers.items()), flush=True)
    if readers["permute python"]:
        raise AssertionError("lookup keys read in Python on the card")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
