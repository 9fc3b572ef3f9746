"""The harness loads neither JAX nor the JAX package, judged by whole
top-level module names, and the yardstick's modules import nothing of
the port."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.lib import harness

LIB = Path(harness.BENCH_DIR) / "lib"


def test_forbidden_by_whole_top_level_name():
    mods = ["graph_kmer_index_tpu_torch", "graph_kmer_index_tpu_torch.ops",
            "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "graph_kmer_index_tpu", "graph_kmer_index_tpu.ops"):
        assert harness.forbidden_modules(mods + [bad]) == [bad.split(".")[0]]


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_yardstick_imports_nothing_of_the_port():
    for name in ("reference.py", "genome.py", "roofline.py", "checks.py"):
        for mod in imported_names(LIB / name):
            assert mod.split(".")[0] in ("torch", "numpy", "hashlib",
                                         "dataclasses", "__future__"), mod


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU in a fresh process, then sys.modules."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.tests import tiny; "
            "from portbench.lib import harness; "
            "res, _ = tiny.run('map_hashes.wg_signature'); "
            "assert res['correct'], res; "
            "print(harness.forbidden_modules())") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_a_machine_without_a_card():
    """No result line, and a code other than 0, where CUDA is missing."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "map_fasta.wg_signature", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
