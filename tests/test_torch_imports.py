"""The machine with the card has no JAX: the port package and chip_smoke.py
must import with ``jax`` and ``graph_kmer_index_tpu`` unimportable."""
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "graph_kmer_index_tpu_torch"

_PROBE = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["graph_kmer_index_tpu"] = None
import graph_kmer_index_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
for script in ("chip_smoke", "chip_compare"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["graph_kmer_index_tpu"] = None
import numpy as np, torch
from graph_kmer_index_tpu_torch import KmerIndex
from graph_kmer_index_tpu_torch.ops import primitives
rng = np.random.default_rng(0)
kmers = rng.integers(0, 1 << 40, 500).astype(np.uint64)
index = KmerIndex.from_rows(kmers, np.arange(500) % 7, np.arange(500),
                            np.ones(500, np.float32), 101, device="cpu")
index.device_index.PACKED_BYTE_BUDGET = 0
assert index.map_kmers(kmers, 7).sum() == 500
assert index.get_batched(kmers[:50]).shape == (5, 50)
assert kmers[3] in index
idx = torch.arange(1024, dtype=torch.int32) % 64
assert primitives.gather_loop(idx, torch.ones((64, 2), dtype=torch.int32),
                              256).tolist() == [256] * 4
assert int(primitives.rmw_loop(idx, 64, 2)[:, 0].sum()) == 1024
print("ok")
"""


def test_port_lookup_runs_without_jax():
    """The CSR path, get_batched, the get API and the probes' twins run
    with jax and the JAX package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+graph_kmer_index_tpu\b"
    r"(?!_torch)|from\s+graph_kmer_index_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
     if "build" not in p.relative_to(PACKAGE).parts]  # kernel build output
    + ["chip_smoke.py", "chip_compare.py"]))
def test_no_jax_import_in_source(path):
    assert not _FORBIDDEN.search((ROOT / path).read_text()), path

