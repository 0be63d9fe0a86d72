"""The port's spans and counters (`utils/timers.py`) on the CPU: the span
tree of a k=7 `create_proof` and `create_proofs_batched` (root, phases,
the host work inside them), the phases tiling the root, the proofs still
equal to the goldens, the request ids of pipelined proofs, the host-device
byte counter, the kernels' launch counters, the set-up spans' names, the spans as torch.profiler
ranges, and nothing kept in memory outside `record()`."""

import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_batch import GOLDEN as BATCH_GOLDEN  # noqa: E402
from test_torch_batch import SEED as BATCH_SEED  # noqa: E402
from test_torch_batch import WITNESSES  # noqa: E402
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

from delay_enc_tpu_torch.ops import _cuda  # noqa: E402
from delay_enc_tpu_torch.ops import limbs as L  # noqa: E402
from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS, TICK, Metrics  # noqa: E402

PHASES = ["advice commit", "lookup permuted", "grand products", "quotient", "evals", "gwc"]
# the host work each phase names, at least
WORK = {
    "advice commit": {"columns", "to_mont", "htod", "fold", "fold/device wait"},
    "lookup permuted": {"columns", "permute", "to_mont", "htod", "fold", "fold/device wait"},
    "grand products": {"to_mont", "htod", "device wait", "fold", "fold/device wait"},
    "quotient": {"columns", "to_mont", "htod", "fold", "fold/device wait"},
    "evals": {"to_mont", "htod", "device wait"},
    "gwc": {"to_mont", "htod", "fold", "fold/device wait"},
}
ROOTS = {"single": "prove", "batched": "prove_batch"}


@pytest.fixture(scope="module")
def keys():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    builders = [_build_circuit(cs, FR, *w) for w in WITNESSES]
    pk, _ = keygen(builders[0], srs, device="cpu")
    return srs, pk, builders


def _traced(run) -> dict:
    """run() under record() and collect(), with every to_tensor input's
    bytes noted; the counters' growth over it."""
    inputs = []
    to_tensor = L.to_tensor

    def spy(words, device):
        inputs.append(np.asarray(words).nbytes)
        return to_tensor(words, device)

    patch = pytest.MonkeyPatch()
    patch.setattr(L, "to_tensor", spy)
    before = GLOBAL_METRICS.snapshot()
    try:
        with GLOBAL_METRICS.record() as records, GLOBAL_METRICS.collect() as totals:
            out = run()
    finally:
        patch.undo()
    after = GLOBAL_METRICS.snapshot()
    counters = {k: v - before.get(k, 0) for k, v in after.items() if k.startswith("#")}
    return {"out": out, "records": list(records), "totals": totals, "counters": counters,
            "inputs": inputs}


@pytest.fixture(scope="module", params=sorted(ROOTS))
def traced(request, keys):
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_batched

    srs, pk, builders = keys
    if request.param == "single":
        run = lambda: [create_proof(srs, pk, builders[0], np.random.default_rng(SEED),
                                    device="cpu")]
    else:
        run = lambda: create_proofs_batched(srs, pk, builders,
                                            np.random.default_rng(BATCH_SEED), device="cpu")
    return request.param, _traced(run)


def _parent_of(span, records):
    """The recorded spans that can be span's parent: its parent's name,
    its request, its interval inside theirs."""
    return [p for p in records if p.name == span.parent and p.request == span.request
            and p.start_ns <= span.start_ns and span.end_ns <= p.end_ns]


def test_span_tree(traced):
    """One root with the six phases; every child inside its one parent;
    siblings apart; each phase names its host work."""
    kind, t = traced
    root_name, recs = ROOTS[kind], t["records"]
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [root_name]
    assert all(r.request == roots[0].request for r in recs)
    assert [r.name for r in recs if r.parent == root_name] == \
        [f"{root_name}/{p}" for p in PHASES]
    for r in recs:
        if r.parent is not None:
            assert len(_parent_of(r, recs)) == 1, r
    for p in recs:
        kids = sorted((r for r in recs if r.parent == p.name and p.start_ns <= r.start_ns
                       and r.end_ns <= p.end_ns), key=lambda r: r.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:])), p
    names = {r.name for r in recs}
    for phase, work in WORK.items():
        assert {f"{root_name}/{phase}/{w}" for w in work} <= names, phase
    instances = len(t["out"])
    assert sum(r.name == f"{root_name}/lookup permuted/permute" for r in recs) == 4 * instances
    leaves = {r.name.rsplit("/", 1)[1] for r in recs if r.parent not in (None, root_name)}
    assert leaves == {"columns", "permute", "to_mont", "htod", "device wait", "fold"}


def test_phases_tile_the_root(traced):
    """The phases follow each other inside the root and cover it but for
    the steps between them; each span's total is its recorded seconds."""
    kind, t = traced
    recs = t["records"]
    (root,) = [r for r in recs if r.parent is None]
    phases = [r for r in recs if r.parent == ROOTS[kind]]
    bounds = [root.start_ns] + [b for p in phases for b in (p.start_ns, p.end_ns)] + [root.end_ns]
    assert bounds == sorted(bounds)
    uncovered = (root.end_ns - root.start_ns) - sum(p.end_ns - p.start_ns for p in phases)
    assert 0 <= uncovered <= max(0.01 * (root.end_ns - root.start_ns), 5e6)
    for name in {r.name for r in recs}:
        mine = [r.end_ns - r.start_ns for r in recs if r.name == name]
        # each span's seconds are a whole number of TICK
        assert abs(t["totals"][name] - sum(mine) * 1e-9) <= len(mine) * TICK


def test_proof_bytes_equal_the_goldens(traced):
    kind, t = traced
    with np.load(GOLDEN if kind == "single" else BATCH_GOLDEN) as z:
        want = [z["proof"].tobytes()] if kind == "single" else [p.tobytes() for p in z["proofs"]]
    assert t["out"] == want


def test_single_proof_and_batch_of_one_name_the_same_spans(keys):
    """create_proof and create_proofs_batched of one builder run one
    pipeline: the same span names under their roots `prove` and
    `prove_batch`, the names the benchmark's readers take."""
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_batched

    srs, pk, builders = keys
    runs = {"prove": lambda: create_proof(srs, pk, builders[0], np.random.default_rng(SEED),
                                          device="cpu"),
            "prove_batch": lambda: create_proofs_batched(srs, pk, builders[:1],
                                                         np.random.default_rng(SEED),
                                                         device="cpu")}
    names = {}
    for root, run in runs.items():
        with GLOBAL_METRICS.record() as recs:
            run()
        assert {r.name.split("/", 1)[0] for r in recs} == {root}
        names[root] = {r.name[len(root):] for r in recs}
    assert names["prove"] == names["prove_batch"]
    assert {f"/{p}" for p in PHASES} < names["prove"]


def test_htod_bytes_count_the_inputs(traced):
    """`htod bytes` is the bytes of to_tensor's inputs; it and `device
    waits` (the reads back, `test_device_waits_count_the_reads_back`) are
    the counters at the host-device boundary.  Beside them and the
    launches, only to_mont's two counters and the lookup permutation's
    two, with every element and every row taken by the C readers, the
    split quotient's, which a fused proof leaves where it was, and the
    staging buffer's: one grow (with its bytes) or one reuse a run."""
    _, t = traced
    c = t["counters"]
    assert t["inputs"] and c["#htod bytes"] == sum(t["inputs"])
    assert {k for k in c if not k.startswith(
        ("#launches/", "#to_mont ", "#permute ", "#split cosets", "#staging "))} == \
        {"#htod bytes", "#device waits"}
    assert c.get("#staging grow", 0) + c.get("#staging reuse", 0) == 1
    assert (c.get("#staging grow bytes", 0) > 0) == (c.get("#staging grow", 0) == 1)
    assert c["#to_mont python"] == 0 and c["#to_mont native"] > 0
    assert c["#permute python"] == 0 and c["#permute native"] > 0
    assert c.get("#split cosets", 0) == 0


def test_to_mont_device_counts_seven_n_an_instance(keys, traced):
    """`to_mont device` counts the elements whose Montgomery form the card
    computed: 5 advice columns, the instance column and the random
    polynomial, 7 n an instance, B 7 n for a batch of B."""
    _, t = traced
    n = keys[1].vk.domain.n
    assert t["counters"]["#to_mont device"] == 7 * n * len(t["out"])


class _Calls:
    """A C library whose named functions record their element counts."""

    def __init__(self, lib, names):
        self.lib, self.calls = lib, {name: [] for name in names}

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.calls:
            return fn
        return lambda *args: self.calls[name].append(args[1]) or fn(*args)


@pytest.mark.parametrize("kind", sorted(ROOTS))
def test_no_host_montgomery_product_over_the_bulk_words(keys, kind, monkeypatch):
    """On a proof's path the host's Montgomery product (`to_mont_words`)
    runs only over the small conversions, each call under n - usable rows
    an instance and column, and the host's wide reduction
    (`fr_from_uniform_mont`) never; the bytes stay the goldens'."""
    from delay_enc_tpu_torch import native
    from delay_enc_tpu_torch.native import ec
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_batched

    srs, pk, builders = keys
    lib, eclib = _Calls(native.get_lib(), ["to_mont_words"]), \
        _Calls(ec.get_eclib(), ["fr_from_uniform_mont"])
    monkeypatch.setattr(native, "get_lib", lambda: lib)
    monkeypatch.setattr(ec, "get_eclib", lambda: eclib)
    if kind == "single":
        out = [create_proof(srs, pk, builders[0], np.random.default_rng(SEED), device="cpu")]
        with np.load(GOLDEN) as z:
            want = [z["proof"].tobytes()]
    else:
        out = create_proofs_batched(srs, pk, builders, np.random.default_rng(BATCH_SEED),
                                    device="cpu")
        with np.load(BATCH_GOLDEN) as z:
            want = [p.tobytes() for p in z["proofs"]]
    assert out == want
    d = pk.vk.domain
    small = d.n - d.usable_rows
    assert eclib.calls["fr_from_uniform_mont"] == []
    assert lib.calls["to_mont_words"] and \
        max(lib.calls["to_mont_words"]) <= len(out) * 5 * small


# a proof's blocking reads back to the host: the plane sums of its six
# commitment batches (advice, lookups, grand products, random polynomial,
# quotient pieces, GWC witnesses) and two reads of field elements (the
# grand products' totals, the evaluations)
WAITS = 6 + 2


def test_device_waits_count_the_reads_back(keys, monkeypatch):
    """`device waits` is one a `to_numpy` call, the proving thread's one
    way to read a result back: WAITS in every k=7 proof, whatever its
    randomness, and a batch of two on one device reads each result once
    for both instances, so no more than two serial proofs."""
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_batched

    srs, pk, builders = keys
    calls = []
    to_numpy = L.to_numpy
    monkeypatch.setattr(L, "to_numpy", lambda t: calls.append(1) or to_numpy(t))

    def waits(run) -> int:
        before, n = GLOBAL_METRICS.snapshot().get("#device waits", 0), len(calls)
        run()
        got = GLOBAL_METRICS.snapshot()["#device waits"] - before
        assert got == len(calls) - n
        return got

    serial = [waits(lambda: create_proof(srs, pk, builders[0], np.random.default_rng(s),
                                         device="cpu")) for s in (SEED, SEED + 1)]
    assert serial == [WAITS, WAITS]
    batch = waits(lambda: create_proofs_batched(srs, pk, builders,
                                                np.random.default_rng(BATCH_SEED), device="cpu"))
    assert len(builders) == 2 and batch == WAITS


def test_spans_are_profiler_ranges(keys):
    """Under torch.profiler every span is a range `<name> (request <id>)`,
    nested in the profiler's tree as the spans nest in the registry: the
    first two phases' host work, outside a proof (a whole proof's plain
    operations take a minute to profile here)."""
    from delay_enc_tpu_torch.ops.msm import fold_planes_host, identity_proj
    from delay_enc_tpu_torch.plonk.prover import CTX, _advice_columns, _lookup_columns

    _, pk, builders = keys
    n, usable = pk.vk.domain.n, pk.vk.domain.usable_rows
    rng = np.random.default_rng(0)
    span = GLOBAL_METRICS.span
    with profile(activities=[ProfilerActivity.CPU]) as prof, GLOBAL_METRICS.record() as recs:
        with span("prove"):
            with span("advice commit"):
                cols = _advice_columns(builders[0], n, usable, rng)
                L.to_tensor(np.stack([CTX.to_mont_np(c) for c in cols]), "cpu")
                fold_planes_host(identity_proj("cpu").expand(1, 127, 3, L.NW))
            with span("lookup permuted"):
                _lookup_columns(builders[0], n, usable, 5, rng,
                                np.empty((8, n, L.NW), dtype=np.uint32), shared_pads=True)
    ranges = [(e.name, e.cpu_parent.name if e.cpu_parent is not None else None)
              for e in prof.events() if " (request " in e.name]
    assert {r.name.rsplit("/", 1)[1] for r in recs if r.name.count("/") > 1} == \
        {"columns", "permute", "to_mont", "htod", "fold", "device wait"}
    label = lambda name, request: f"{name} (request {request})"
    assert sorted(name for name, _ in ranges) == sorted(label(r.name, r.request) for r in recs)
    for r in recs:
        parents = {parent for name, parent in ranges if name == label(r.name, r.request)}
        assert parents == {label(r.parent, r.request) if r.parent is not None else None}, r


def test_pipelined_proofs_keep_their_requests(keys):
    """Depth 2: each worker's proof is a root of its own request, its
    phases once each, and every span's parent is of its own request."""
    from delay_enc_tpu_torch.plonk import create_proofs_pipelined

    srs, pk, builders = keys
    with GLOBAL_METRICS.record() as recs:
        create_proofs_pipelined(srs, pk, builders, seeds=[11, 22], depth=2, device="cpu")
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["prove", "prove"]
    assert roots[0].request != roots[1].request
    assert {r.request for r in recs} == {r.request for r in roots}
    for root in roots:
        mine = [r for r in recs if r.request == root.request]
        assert [r.name for r in mine if r.parent == "prove"] == [f"prove/{p}" for p in PHASES]
        for r in mine:
            assert root.start_ns <= r.start_ns and r.end_ns <= root.end_ns
            if r.parent is not None:
                assert len(_parent_of(r, recs)) == 1, r


def test_launch_counters_are_the_registry(monkeypatch):
    """A kernel's launches count into the registry as `launches/<name>`;
    launch_counts() and reset_launches() read and drop those counters, and
    Metrics.clear() drops them with the rest."""
    k = _cuda.kernel("spans_test_kernel", "spans_test_symbol", "nothing", "nowhere")
    monkeypatch.delitem(_cuda.KERNELS, "spans_test_kernel")
    monkeypatch.setitem(_cuda.KERNELS, "spans_test_kernel", k)
    monkeypatch.setitem(_cuda._fns, "spans_test_symbol", lambda *args: 0)
    _cuda.reset_launches()
    for _ in range(3):
        k()
    assert GLOBAL_METRICS.snapshot()["#launches/spans_test_kernel"] == 3
    assert _cuda.launch_counts()["spans_test_kernel"] == k.launches == 3
    _cuda.reset_launches()
    assert _cuda.launch_counts()["spans_test_kernel"] == k.launches == 0
    assert "#launches/spans_test_kernel" not in GLOBAL_METRICS.snapshot()
    k()
    GLOBAL_METRICS.clear()
    assert _cuda.launch_counts()["spans_test_kernel"] == k.launches == 0
    assert GLOBAL_METRICS.snapshot() == {}


def test_set_up_spans_nest_once(keys, tmp_path):
    """keygen is a root `keygen` with its steps inside; get_keys nests it
    under `keys` once (`keys/keygen/...`) beside `keys/save_pk`, and a
    cached key gives `keys/load_pk`."""
    from delay_enc_tpu_torch.runtime.workloads import get_keys

    srs, _, builders = keys
    steps = {"host columns", "sigma labels", "to_mont", "htod", "transforms", "commit"}
    with GLOBAL_METRICS.record() as made:
        get_keys("delay_enc", builders[0], srs, K, str(tmp_path), device="cpu")
    with GLOBAL_METRICS.record() as loaded:
        get_keys("delay_enc", builders[0], srs, K, str(tmp_path), device="cpu")
    names = {r.name for r in made}
    assert {r.name for r in made if r.parent is None} == {"keys"}
    assert {"keys/keygen", "keys/save_pk"} | {f"keys/keygen/{s}" for s in steps} <= names
    assert not [n for n in names if "keygen/keygen" in n or n.startswith("keys/keys")]
    assert [r.name for r in loaded if r.parent == "keys"] == ["keys/load_pk"]


def test_nothing_is_kept_outside_record():
    """Without record() and a profiler, spans keep only their totals;
    record() keeps the spans that close inside it and none after."""
    m = Metrics()
    assert not torch.autograd._profiler_enabled()

    def spans(count):
        for _ in range(count):
            with m.span("root"), m.span("child"):
                pass

    spans(100)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        spans(5000)
        grown = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert grown < 16 * 1024
    assert set(m.spans) == {"root", "root/child"}
    with m.record() as kept:
        assert kept == []
        spans(1)
    assert [s.name for s in kept] == ["root/child", "root"]
    spans(1)
    assert len(kept) == 2


def test_names_and_requests_by_thread():
    """Spans nest by thread: each thread's root takes its own request id,
    which its children carry; the counters sit in the snapshot under `#`."""
    m = Metrics()
    start = threading.Barrier(4)

    def work():
        start.wait(timeout=30)
        with m.span("root"), m.span("a"), m.span("b"):
            m.count("calls")

    threads = [threading.Thread(target=work) for _ in range(4)]
    with m.record() as recs:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(s.name for s in recs) == sorted(["root", "root/a", "root/a/b"] * 4)
    by_request = {}
    for s in recs:
        by_request.setdefault(s.request, set()).add((s.name, s.parent))
    assert len(by_request) == 4
    assert all(v == {("root", None), ("root/a", "root"), ("root/a/b", "root/a")}
               for v in by_request.values())
    snap = m.snapshot()
    assert snap["#calls"] == 4 and set(snap) == {"root", "root/a", "root/a/b", "#calls"}
    m.clear()
    assert m.snapshot() == {}
