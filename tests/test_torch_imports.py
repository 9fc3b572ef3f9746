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
# the build side: graph -> critical paths -> pooled find with the device
# finalize -> index -> read counts
from graph_kmer_index_tpu_torch import CriticalGraphPaths, native
from graph_kmer_index_tpu_torch.hashing import sliding_window_hashes
from graph_kmer_index_tpu_torch.parallel.host_pool import (
    find_kmers_parallel, find_kmers_parallel_device)
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph
assert native.available(), native.build_error()
graph, _ = random_snp_graph(2000, 30, seed=1, indel_fraction=0.2)
cpaths = CriticalGraphPaths.from_graph(graph, 11)
flat = find_kmers_parallel_device(graph, 11, n_workers=2, mp_context="spawn",
                                  critical_paths=cpaths, device="cpu",
                                  stream_rows_target=1000,
                                  require_native=True)
host = find_kmers_parallel(graph, 11, n_workers=1, critical_paths=cpaths)
assert np.array_equal(flat._hashes.numpy().view(np.uint64), host._hashes)
built = KmerIndex.from_flat_kmers(flat, modulo=1009, device="cpu")
ref = sliding_window_hashes(graph.linear_ref_sequence()[2], 11)
assert built.has_kmers(ref).all()
assert built.map_kmers(ref, graph.n_nodes()).sum() >= len(ref)
print("ok")
"""


def test_port_lookup_runs_without_jax():
    """The CSR path, get_batched, the get API, the probes' twins and the
    build of an index from a graph (native walker, spawned workers) run
    with jax and the JAX package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_SHARDED = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["graph_kmer_index_tpu"] = None
import numpy as np, torch
from graph_kmer_index_tpu_torch import KmerIndex
from graph_kmer_index_tpu_torch.parallel import checkpoint, mesh, oocbuild
from graph_kmer_index_tpu_torch.parallel.sharded import (
    KMER_PAD, make_count_step_packed)
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph
graph, _ = random_snp_graph(3000, 30, seed=2, indel_fraction=0.2)
with tempfile.TemporaryDirectory() as wd:
    oocbuild.find_and_build_out_of_core(graph, 11, n_workers=2, workdir=wd,
                                        modulo=1009, n_ranges=3)
    index = oocbuild.index_from_shard_checkpoint(wd + "/index", "cpu")
    packed = oocbuild.convert_checkpoint_to_packed(wd + "/index", wd,
                                                   n_table=1)
    mesh.start_process_group("cpu")
    m = mesh.build_mesh(1, 1)
    shards = checkpoint.load_shards(packed["prefix"], mesh=m)
    step = make_count_step_packed(m, shards, graph.n_nodes(), 11,
                                  from_kmers=True)
    q = torch.cat([index.kmers, torch.full((3,), KMER_PAD)])
    counts = step(q, shards.records, shards.row_kmers, shards.row_nodes)
    mesh.stop_process_group()
assert np.array_equal(counts.numpy(), index.map_kmers(index.kmers,
                                                      graph.n_nodes()))
print("ok")
"""


def test_sharded_path_runs_without_jax():
    """The out-of-core build (spawned pool workers), the packed
    conversion and a mesh serve of the checkpoint run with jax and the JAX
    package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _SHARDED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_out_of_core_workers_import_numpy_alone():
    """The out-of-core build's modules, which its pool workers import,
    do not import torch."""
    probe = ("import sys; import graph_kmer_index_tpu_torch.parallel."
             "oocbuild, graph_kmer_index_tpu_torch.parallel.host_pool; "
             "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+graph_kmer_index_tpu\b"
    r"(?!_torch)|from\s+graph_kmer_index_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
     if "build" not in p.relative_to(PACKAGE).parts]  # kernel build output
    + ["chip_smoke.py", "chip_compare.py"]))
def test_no_jax_import_in_source(path):
    assert not _FORBIDDEN.search((ROOT / path).read_text()), path

