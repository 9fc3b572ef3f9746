"""The dense cell's faults: a run of ``map_hashes.chr13_dense`` with the
port's build broken underneath comes out not correct (the harness's look
for a card skipped, everything else as in a run, on the CPU at a test's
size), and its control reads above the limit of 0 on every seed."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_kmer_index_tpu_torch.finder as finder
import graph_kmer_index_tpu_torch.models.kmer_index as kmer_index

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import dense_control, harness  # noqa: E402

torch.set_num_threads(2)

CELL = "map_hashes.chr13_dense"


def config(n_bases: int = 60_000) -> dict:
    return dict(harness.load_json("configs", "chr13_dense"),
                ref_bases=n_bases, n_variants=int(n_bases * 88.3 / 3100),
                modulo=1009, find_workers=2)


def traffic() -> dict:
    return dict(harness.load_json("traffic", "map_hashes"),
                reads_per_request=300, pool_requests=2)


def run(seed: int = 2 ** 31 + 17):
    man = harness.manifest()
    return harness.run_cell(harness.find_cell(man, CELL), seed, 0.2, False,
                            "cpu", 0.0, config=config(), traffic=traffic(),
                            per_layer=man["per_layer"],
                            end_to_end=man["end_to_end"])


def wrong(result, *names):
    res, found = result
    assert res["correct"] is False
    bad = {n for n, v, limit in found if v > limit}
    assert bad & set(names), found


def test_a_sound_run_is_correct():
    res, found = run()
    assert res["correct"], found


def _starts(lengths):
    return np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)


def test_windows_through_two_variants_dropped(monkeypatch):
    """Every window whose nodes hold alleles of two variants or more
    yields no row (the node of an allele is 3i + 2 or 3i + 3)."""
    real = finder._dedup_span_nodes

    def dropped(raw_nl, raw_nodes, *args):
        nl, _, nodes, af = real(raw_nl, raw_nodes, *args)
        span = np.repeat(np.arange(len(raw_nl)), raw_nl)
        allele = raw_nodes % 3 != 1
        pairs = np.unique(np.stack([span[allele],
                                    (raw_nodes[allele] - 2) // 3]), axis=1)
        variants = np.bincount(pairs[0], minlength=len(raw_nl))
        keep = variants < 2
        nodes = nodes[np.repeat(keep, nl)]
        nl = np.where(keep, nl, 0)
        return nl, _starts(nl), nodes, af

    monkeypatch.setattr(finder, "_dedup_span_nodes", dropped)
    wrong(run(), "index_rows")


def test_the_largest_node_kept_instead_of_the_smallest(monkeypatch):
    real = finder._dedup_span_nodes

    def largest(raw_nl, raw_nodes, af_table, only_save_one=False,
                only_store_nodes=None):
        nl, ns, nodes, af = real(raw_nl, raw_nodes, af_table, False,
                                 only_store_nodes)
        if not only_save_one:
            return nl, ns, nodes, af
        last = nodes[(ns + nl - 1)[nl > 0]]
        nl = np.minimum(nl, 1)
        return nl, _starts(nl), last, af

    monkeypatch.setattr(finder, "_dedup_span_nodes", largest)
    wrong(run(), "index_rows")


def test_a_frequency_altered_where_it_is_produced(monkeypatch):
    real = kmer_index.frequencies_by_distinct_ref_offsets

    def altered(kmers, ref_offsets):
        out = real(kmers, ref_offsets)
        out[len(out) // 2] += 1
        return out

    monkeypatch.setattr(kmer_index, "frequencies_by_distinct_ref_offsets",
                        altered)
    wrong(run(), "index_frequencies")


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_the_control_fails(seed):
    found = dense_control.readings(config(), traffic(), seed, "cpu")
    assert found["index_rows"] > 0, found


def test_the_reference_in_the_controls_place_reads_zero():
    found = dense_control.readings(config(), traffic(), 4, "cpu",
                                   max_variant_nodes=5)
    assert set(found.values()) == {0}, found
