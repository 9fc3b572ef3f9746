"""Read mapping from host k-mer hashes against an index whose packed table
exceeds the card's budget, so that the port's ``map_kmers`` takes the CSR
bucket scan (``ops/lookup.py``: the span ``lookup.csr``). A request is
``map_hashes``'s, and so are set-up, the step and the finish.

The check judges the index by blocks of buckets
(``lib/bucket_checks.py``), so that the reference's rows and the judged
copies fit beside an index of some 576 M rows on one card; the node
counts as ``map_hashes`` judges them. The yardstick counts the bytes of a
CSR lookup (``lib/csr_roofline.py``) in place of K2's."""
from __future__ import annotations

import torch

from portbench.lib import (bucket_checks, checks, csr_roofline, harness,
                           reference)

_map_hashes = harness.load_module("drivers", "map_hashes")
setup = _map_hashes.setup
step = _map_hashes.step
finish = _map_hashes.finish


def check(run, state) -> list:
    """The index against the reference's rows, by blocks of buckets; then,
    with the index gone, the node counts of the kept requests."""
    dev = run.device
    idx = state.idx
    state.rows = idx.reference_rows(dev)
    found = bucket_checks.index_checks(idx.index, state.rows, idx.modulo,
                                       dev)
    idx.index = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    i_last, item, _kmers, counts = state.last
    state.last = None
    kept = dict(state.sample.kept)
    kept[i_last] = (item, counts)
    found.append(("node_counts", checks.count_checks(
        kept, lambda j: state.reads[j].to(dev), state.rows[:2],
        state.n_nodes, dev), checks.LIMIT))
    return found


def yardstick(run, state) -> None:
    """Bytes that the window's CSR lookups had to move (``csr_bytes``),
    and the window's queries whose bucket holds a row (``csr_queries``),
    from the reads and the reference's rows."""
    dev = run.device
    table = csr_roofline.CsrTable(state.rows[0], state.rows[1],
                                  state.idx.modulo)
    n_items = len(state.pool)
    nbytes = nonempty = 0
    for item in range(n_items):
        requests = len(range(item, run.requests, n_items))
        if not requests:
            continue
        queries = reference.batch_hashes(state.reads[item].to(dev))
        nbytes += requests * csr_roofline.csr_bytes(table, queries,
                                                    state.n_nodes)
        nonempty += requests * csr_roofline.nonempty_queries(table, queries)
        del queries
    run.yard.update(csr_bytes=nbytes, csr_queries=nonempty,
                    requests=run.requests)
