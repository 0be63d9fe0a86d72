"""Nothing the benchmark runs imports JAX or the JAX package, compared by
top-level module name."""

import glob
import os
import subprocess
import sys

from gpubench import imports

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_top_level_names_compared_whole():
    assert imports.forbidden_loaded(["delay_enc_tpu_torch", "delay_enc_tpu_torch.plonk",
                                     "jaxtyping", "numpy"]) == []
    assert imports.forbidden_loaded(["delay_enc_tpu", "delay_enc_tpu.plonk.prover", "jax.numpy",
                                     "jaxlib", "flax.linen", "torch"]) == [
        "delay_enc_tpu", "delay_enc_tpu.plonk.prover", "flax.linen", "jax.numpy", "jaxlib"]


def test_source_scan():
    assert imports.forbidden_imports("import delay_enc_tpu_torch.plonk\nimport jaxtyping") == []
    assert imports.forbidden_imports("from delay_enc_tpu.plonk import SRS") == [
        "delay_enc_tpu.plonk"]
    assert imports.forbidden_imports("import jax.numpy as jnp") == ["jax.numpy"]
    assert imports.forbidden_imports("from . import jax") == []


def test_no_source_of_the_benchmark_imports_them():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert imports.forbidden_imports(f.read()) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        with open(path) as f:
            src = f.read()
        names = [n for n in imports.ast.walk(imports.ast.parse(src))
                 if isinstance(n, (imports.ast.Import, imports.ast.ImportFrom))]
        for node in names:
            mods = ([a.name for a in node.names] if isinstance(node, imports.ast.Import)
                    else [node.module or ""])
            for m in mods:
                assert imports.top_level(m) not in ("delay_enc_tpu_torch", "torch"), (path, m)


def test_the_run_path_loads_neither():
    """What a run imports (the harness, every metric reader, the program's
    entry points) leaves no forbidden module in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench import harness, registry, control, imports\n"
        "bench = registry.load_benchmark()\n"
        "for m in bench['end_to_end'] + bench['per_layer']: registry.load_metric(m['name'])\n"
        "from delay_enc_tpu_torch import plonk, native\n"
        "from delay_enc_tpu_torch.runtime.workloads import build_circuit\n"
        "from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS\n"
        "print(imports.forbidden_loaded())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip() == "[]"
