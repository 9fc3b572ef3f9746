"""(The port's copy of graph_kmer_index_tpu/utils/serialize.py.)
Generic object (de)serialization — replaces the reference's external
``shared_memory_wrapper.to_file/from_file`` (used by its CLI for counters,
critical paths and bundles, command_line_interface.py:25,545,653)."""
from __future__ import annotations

import pickle


def to_file(obj, file_name):
    with open(file_name, "wb") as f:
        pickle.dump(obj, f)
    return file_name


def from_file(file_name):
    with open(file_name, "rb") as f:
        return pickle.load(f)
