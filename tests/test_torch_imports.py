"""The port loads neither jax nor delay_enc_tpu, and its entry points refuse
to run on the CPU unless asked.  Both run in a fresh interpreter, because
tests/conftest.py imports jax into this one."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_without_jax():
    code = """
import importlib, pkgutil, sys
import delay_enc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "delay_enc_tpu"))
assert not bad, bad
assert len(names) > 40, names
print("ok", len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_entry_points_without_device_raise_on_cpu_only_machine():
    code = """
import numpy as np
from delay_enc_tpu_torch.plonk import SRS, keygen, create_proof
from delay_enc_tpu_torch import state
checks = [
    lambda: SRS.setup(3, tau=5),
    lambda: SRS.load("bench_data_cpu/srs_bn254_k11.npz"),
    lambda: keygen(None, None),
    lambda: create_proof(None, None, None),
    lambda: state.from_jax_limbs(np.zeros((2, 16), np.uint32)),
]
for check in checks:
    try:
        check()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("ran without a card")
srs = SRS.setup(3, tau=5, device="cpu")
assert srs.device.type == "cpu"
print("ok")
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
