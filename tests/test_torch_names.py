"""The port's coverage of the JAX package's names, and its independence.

- `Domain.lagrange_at`, `Domain.l_blind_at` and `ops/limbs.py:eq` against
  the JAX package's, bit for bit, on inputs from a seed;
- every public function, class and method of the JAX package has a port
  under the same module and name, or a reason recorded in ROADMAP.md;
- no source of the port, chip_smoke.py or the port's tools imports jax or
  anything of delay_enc_tpu (read with `ast`, not by importing);
- the entry points that take a device need a card unless given the CPU;
- the host C libraries: `native.status` names what loaded, `native.require`
  raises with the reason when a library does not build.
"""

import ast
import importlib
import importlib.util
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import delay_enc_tpu
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.plonk.domain import Domain as JDomain
from delay_enc_tpu_torch import native
from delay_enc_tpu_torch.fields import FR
from delay_enc_tpu_torch.ops import limbs as L
from delay_enc_tpu_torch.plonk.domain import BLINDING_ROWS, Domain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points(k: int, rng) -> list:
    """x values: random field elements, 0, 1, and every row of the domain
    (in it, l_i vanishes off row i and the formula divides by 0 on it)."""
    d = Domain(k)
    xs = [FR.random(rng) for _ in range(4)] + [0, 1, FR.p - 1]
    return xs + [pow(d.omega, j, FR.p) for j in range(d.n)]


def _same(f, g, *args):
    """f(*args) == g(*args), or both raise ValueError."""
    try:
        want = f(*args)
    except ValueError:
        with pytest.raises(ValueError):
            g(*args)
        return "raises"
    assert g(*args) == want, args
    return want


@pytest.mark.parametrize("k", [3, 4])
def test_lagrange_at_matches_jax(k):
    rng = np.random.default_rng(k)
    port, ref = Domain(k), JDomain(k)
    n = 1 << k
    rows = sorted({0, 1, port.usable_rows, n - 1, *rng.integers(0, n, 3).tolist()})
    outcomes = set()
    for i in rows:
        for x in _points(k, rng):
            got = _same(ref.lagrange_at, port.lagrange_at, i, x)
            outcomes.add("raises" if got == "raises" else "zero" if got == 0 else "value")
    assert outcomes == {"raises", "zero", "value"}
    # a cross-check of the formula: l_i interpolates the indicator of row i
    x = FR.random(rng)
    assert sum(port.lagrange_at(i, x) for i in range(n)) % FR.p == 1


@pytest.mark.parametrize("k", [3, 5])
def test_l_blind_at_matches_jax(k):
    rng = np.random.default_rng(10 + k)
    port, ref = Domain(k), JDomain(k)
    outcomes = set()
    for x in _points(k, rng):
        got = _same(ref.l_blind_at, port.l_blind_at, x)
        outcomes.add("raises" if got == "raises" else "zero" if got == 0 else "value")
    assert outcomes == {"raises", "zero", "value"}
    x = FR.random(rng)
    blind = range(port.n - BLINDING_ROWS, port.n)
    assert port.l_blind_at(x) == sum(port.lagrange_at(i, x) for i in blind) % FR.p


@pytest.mark.parametrize("shape", [(1,), (37,), (3, 5)])
def test_eq_matches_jax(shape):
    """Equal words, words that differ in one 32-bit word, in one 16-bit half
    of a word or in one bit, and broadcasting against one element."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    a = rng.integers(-2**31, 2**31, size=(*shape, L.NW), dtype=np.int64).astype(np.int32)
    b = a.copy()
    flat = b.reshape(-1, L.NW)
    # the lowest bit, the upper half's lowest bit, the top bit, every bit
    flips = np.array([1, 1 << 16, -2**31, -1], np.int32)
    for r in range(0, flat.shape[0], 2):  # every other element differs
        flat[r, rng.integers(0, L.NW)] ^= flips[(r // 2) % len(flips)]
    for x, y in [(a, a), (a, b), (b, a), (a, a[(0,) * len(shape)]), (a, b[(0,) * len(shape)])]:
        got = L.eq(torch.from_numpy(x), torch.from_numpy(y))
        want = np.asarray(JL.eq(L.words_to_limbs_np(x), L.words_to_limbs_np(y)))
        assert got.dtype == torch.bool and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
    assert L.eq(torch.from_numpy(a), torch.from_numpy(a)).all()
    assert not L.eq(torch.from_numpy(a), torch.from_numpy(b)).reshape(-1)[0::2].any()


# JAX names with no port under the same module and name; each name stands in
# ROADMAP.md §1 "Not ported, on purpose" with its reason
NOT_PORTED = {
    "ops.limbs": {"int_to_limbs_np", "ints_to_limbs_np", "limbs_to_ints_np", "FieldCtx.make",
                  "force_unroll", "pack", "unpack", "ll_zero_like", "ll_carry_and_mod", "ll_add",
                  "ll_sub", "ll_mont_mul", "ll_select", "ll_const"},
    "ops.msm": {"scalar_bits_from_limbs", "scalars_to_limbs", "proj_batch_to_affine_host"},
    "ops.msm_pallas": {"<module>"},
    "ops.ntt_mxu": {"MXUPlan.arrays", "ntt_mxu_raw"},
    "ops.poly": {"scan_impl_env"},
    "parallel.ntt": {"local_ntt_inv_unscaled"},
    "plonk.domain": {"Domain.mxu_fwd", "Domain.mxu_inv", "Domain.mxu_ext", "Domain.mxu_ext_inv"},
    "plonk.kernels": {"ext_batch_padded"},
    "plonk.selfcheck": {"level"},
    "utils.jaxcfg": {"<module>"},
}


def _jax_modules() -> list:
    """The JAX package's Python modules (not its built C libraries)."""
    return [m.name for m in pkgutil.walk_packages(delay_enc_tpu.__path__, "delay_enc_tpu.")
            if (importlib.util.find_spec(m.name).origin or "").endswith(".py")]


def _public_names(mod) -> set:
    """Public functions and classes defined in `mod`, and the public
    methods and properties of those classes, as "name" or "Class.name"."""
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out.add(name)
        elif inspect.isclass(obj):
            out.add(name)
            out |= {f"{name}.{a}" for a, v in vars(obj).items()
                    if not a.startswith("_") and hasattr(v, "__get__")}
    return out


def test_every_jax_name_has_a_port():
    missing = {}
    for name in _jax_modules():
        rel = name[len("delay_enc_tpu."):]
        want = _public_names(importlib.import_module(name))
        try:
            port = importlib.import_module(f"delay_enc_tpu_torch.{rel}")
        except ModuleNotFoundError:
            missing[rel] = {"<module>"}
            continue
        gone = set()
        for n in want:
            obj = port
            for part in n.split("."):
                obj = getattr(obj, part, None)
            if obj is None:
                gone.add(n)
        if gone:
            missing[rel] = gone
    assert missing == NOT_PORTED
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    for rel, names in NOT_PORTED.items():
        for n in names:
            assert (n.split(".")[-1] if n != "<module>" else rel.split(".")[-1]) in roadmap, n


def _sources() -> list:
    pkg = os.path.join(ROOT, "delay_enc_tpu_torch")
    build = os.path.join(pkg, "build")  # build outputs, and checkouts unpacked for comparisons
    out = [os.path.join(d, f) for d, _, fs in os.walk(pkg) if not d.startswith(build)
           for f in fs if f.endswith(".py")]
    tools = os.path.join(ROOT, "tools")
    out += [os.path.join(tools, f) for f in os.listdir(tools)
            if f.startswith("torch_") and f.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def _imported(tree) -> set:
    """Top-level names of every absolute import in the tree, and of every
    constant string given to importlib.import_module or __import__."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_port_sources_import_no_jax():
    sources = _sources()
    assert len(sources) > 60
    bad = {}
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        hit = _imported(tree) & {"jax", "jaxlib", "delay_enc_tpu"}
        if hit:
            bad[os.path.relpath(path, ROOT)] = sorted(hit)
    assert not bad
    # the reader sees a violation
    assert _imported(ast.parse("import jax.numpy as jnp")) == {"jax"}
    assert _imported(ast.parse("def f():\n from delay_enc_tpu.ops import limbs")) == {
        "delay_enc_tpu"}
    assert _imported(ast.parse("importlib.import_module('delay_enc_tpu.plonk')")) == {
        "delay_enc_tpu"}
    assert _imported(ast.parse("from . import limbs\nfrom ..ops import msm")) == set()


def test_more_entry_points_need_a_card():
    """Entry points beyond tests/test_torch_imports.py's: each raises
    without a card unless given the CPU."""
    code = """
import numpy as np
from delay_enc_tpu_torch.plonk import create_proofs_batched, create_proofs_pipelined
from delay_enc_tpu_torch.plonk.serialize import load_pk
from delay_enc_tpu_torch.parallel import ShardedNTTPlan, dryrun_multichip, make_mesh
from delay_enc_tpu_torch.plonk.domain import Domain
from delay_enc_tpu_torch.runtime.workloads import get_keys
checks = [
    lambda: create_proofs_batched(None, None, [None], None),
    lambda: create_proofs_pipelined(None, None, [None], seeds=[1]),
    lambda: load_pk("no-such-key"),
    lambda: make_mesh(1),
    lambda: ShardedNTTPlan.make(12, 1),
    lambda: dryrun_multichip(1),
    lambda: get_keys("pose_enc", None, None, 11, "no-such-dir"),
]
for i, check in enumerate(checks):
    try:
        check()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), (i, e)
    else:
        raise AssertionError(f"check {i} ran without a card")
assert Domain(3).plan("cpu").tw.device.type == "cpu"
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_native_status_names_the_loaded_libraries():
    st = native.status()
    assert set(st) == {"limbops", "ecops"}
    assert all(path and os.path.exists(path) for path in st.values()), st
    assert native.require() == st


def test_native_require_raises_when_a_library_does_not_build(tmp_path, monkeypatch):
    """A source the compiler refuses: get_lib and get_eclib give None (the
    Python paths), status says so, require raises with cc's reason."""
    (tmp_path / "limbops.c").write_text("this is not C;\n")
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_eclib", None)
    monkeypatch.setattr(native, "_ECLIB_TRIED", False)
    monkeypatch.setattr(native, "_ERRORS", {})
    assert native.get_lib() is None and native.get_eclib() is None
    assert native.status() == {"limbops": None, "ecops": None}
    with pytest.raises(RuntimeError, match=r"(?s)limbops \(cc .*ecops \(cc") as e:
        native.require()
    assert "not C" in str(e.value) or "error" in str(e.value)
