"""IndexBundle — the KAGE genotyper's bundle of indexes in one file
(reference index_bundle.py:9-19); the port of
graph_kmer_index_tpu/models/bundle.py, whose files it reads and writes:
the manifest stores the JAX package's class names, and a KmerIndex is
stored under class ``CollisionFreeKmerIndex`` with that class's property
names and dtypes (KmerIndex.to_properties) and rebuilt on the device
that ``from_file`` names.

The reference serializes through the external ``shared_memory_wrapper``
package's ``to_file/from_file`` (index_bundle.py:15-19), which decomposes
an object tree into its numpy arrays and writes one npz. That package is
not available here, so byte-exact compatibility with KAGE-released
bundles cannot be generated or tested; instead this module implements
the same DESIGN — one
self-describing ``.npz`` holding every index's ``properties`` arrays
under hierarchical ``<IndexName>/<prop>`` keys plus a JSON manifest —
and a tolerant loader:

- native npz bundles (hierarchical keys + ``__manifest__``),
- foreign npz bundles with recognisable hierarchical keys (grouped by
  their first path component and reconstructed into the known index
  classes by property-name match),
- pickle bundles (legacy fallback; a pickle names its classes' modules,
  so one package's pickle does not load in the other).
"""
from __future__ import annotations

import io
import json
import logging
import pickle

import numpy as np

from ..flat_kmers import host_column, is_tensor


def _known_classes():
    from ..containers import Counter, HashTable
    from ..graph import Graph, VariantToNodes
    from .counters import KmerCounter
    from .kmer_index import CounterKmerIndex, KmerIndex
    return {
        "VariantToNodes": VariantToNodes,
        "KmerIndex": KmerIndex,
        "CollisionFreeKmerIndex": KmerIndex,
        "Graph": Graph,
        "Counter": Counter,
        "HashTable": HashTable,
        "KmerCounter": KmerCounter,
        "CounterKmerIndex": CounterKmerIndex,
    }


def _decompose(obj, _depth=0):
    """(arrays dict, meta) for one index object: arrays from
    ``properties`` when declared, else every public ndarray attribute.
    Object-valued properties (e.g. CounterKmerIndex's Counter) decompose
    one level deep as ``prop.subprop`` arrays with their class recorded
    in ``meta["nested"]``; anything that still cannot be serialized is
    dropped WITH a warning, never silently."""
    from .kmer_index import KmerIndex
    arrays, scalars, nested = {}, {}, {}
    if isinstance(obj, KmerIndex):
        # the JAX class's properties, its name and its dtypes, so that
        # either package reads the entry
        values = obj.to_properties()
        class_name = "CollisionFreeKmerIndex"
    else:
        props = getattr(obj, "properties", None)
        names = sorted(props) if props else [
            a for a in vars(obj) if not a.startswith("__")]
        values = {name: getattr(obj, name, None) for name in names}
        class_name = type(obj).__name__
    for name in sorted(values):
        value = values[name]
        if value is None:
            continue
        if isinstance(value, np.ndarray):
            arrays[name] = value
        elif is_tensor(value):
            # a column on a device: copied to the host explicitly, so
            # that the bundle holds the index
            arrays[name] = host_column(value)
        elif np.isscalar(value):
            scalars[name] = (value.item() if hasattr(value, "item")
                             else value)
        elif _depth == 0 and hasattr(value, "__dict__"):
            sub_arrays, sub_meta = _decompose(value, _depth=1)
            if sub_arrays or sub_meta["scalars"]:
                for sp, arr in sub_arrays.items():
                    arrays[f"{name}.{sp}"] = arr
                nested[name] = sub_meta
            else:
                logging.warning(
                    "IndexBundle: dropping property %r of %s (%s has no "
                    "serializable arrays)", name, type(obj).__name__,
                    type(value).__name__)
        else:
            logging.warning(
                "IndexBundle: dropping un-serializable property %r of %s "
                "(type %s)", name, type(obj).__name__,
                type(value).__name__)
    meta = {"class": class_name, "scalars": scalars}
    if nested:
        meta["nested"] = nested
    return arrays, meta


def _reconstruct(class_name, arrays, scalars, nested=None, device="cpu"):
    from .kmer_index import KmerIndex
    cls = _known_classes().get(class_name)
    kwargs = {k: v for k, v in arrays.items() if "." not in k}
    kwargs.update(scalars)
    for prop, sub_meta in (nested or {}).items():
        sub_arrays = {k.split(".", 1)[1]: v for k, v in arrays.items()
                      if k.startswith(prop + ".")}
        kwargs[prop] = _reconstruct(sub_meta["class"], sub_arrays,
                                    sub_meta.get("scalars", {}),
                                    sub_meta.get("nested"), device)
    if cls is KmerIndex:
        return KmerIndex.from_properties(kwargs, device)
    if cls is None:
        # unknown index type: hand back a plain namespace so callers can
        # still reach the arrays
        import types
        return types.SimpleNamespace(**kwargs)
    try:
        return cls(**kwargs)
    except TypeError:
        obj = cls.__new__(cls)
        for k, v in kwargs.items():
            setattr(obj, k, v)
        return obj


class IndexBundle:
    index_names = ["VariantToNodes", "NumpyVariants", "NodeCountModelAdvanced",
                   "HelperVariants", "CombinationMatrix", "TrickyVariants",
                   "KmerIndex"]

    def __init__(self, indexes):
        self.indexes = indexes

    def __getitem__(self, name):
        return self.indexes[name]

    def __setitem__(self, name, value):
        self.indexes[name] = value

    def __contains__(self, name):
        return name in self.indexes

    def to_file(self, file_name, compress=True):
        payload = {}
        manifest = {}
        for name, obj in self.indexes.items():
            if isinstance(obj, (list, tuple)):
                obj = np.asarray(obj)
            if isinstance(obj, np.ndarray):
                payload[f"{name}/__array__"] = obj
                manifest[name] = {"class": "ndarray", "scalars": {}}
                continue
            arrays, meta = _decompose(obj)
            for prop, arr in arrays.items():
                payload[f"{name}/{prop}"] = arr
            manifest[name] = meta
        payload["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        save = np.savez_compressed if compress else np.savez
        out = file_name if str(file_name).endswith(".npz") else \
            str(file_name) + ".npz"
        save(out, **payload)
        return out

    @classmethod
    def from_file(cls, file_name, skip=None, device="cuda"):
        """The bundle at ``file_name`` (or ``file_name`` + ".npz"), every
        KmerIndex in it placed on ``device``; ``skip`` names entries to
        leave out."""
        for candidate in (str(file_name), str(file_name) + ".npz"):
            try:
                with open(candidate, "rb") as f:
                    head = f.read(4)
                break
            except FileNotFoundError:
                continue
        else:
            raise FileNotFoundError(file_name)

        if head[:2] == b"PK":  # zip container: npz
            data = np.load(candidate, allow_pickle=False)
            with data:
                indexes = cls._from_npz(data, device)
        else:  # pickle bundles
            with open(candidate, "rb") as f:
                indexes = pickle.load(f)
        if skip and isinstance(indexes, dict):
            indexes = {k: v for k, v in indexes.items() if k not in skip}
        return cls(indexes)

    @staticmethod
    def _from_npz(data, device="cpu"):
        manifest = {}
        if "__manifest__" in data:
            manifest = json.loads(bytes(data["__manifest__"]).decode())
        groups: dict[str, dict] = {}
        for key in data.files:
            if key == "__manifest__" or "/" not in key:
                continue
            name, prop = key.split("/", 1)
            groups.setdefault(name, {})[prop] = data[key]
        indexes = {}
        for name, arrays in groups.items():
            meta = manifest.get(name, {"class": name, "scalars": {}})
            if meta["class"] == "ndarray" or list(arrays) == ["__array__"]:
                indexes[name] = arrays["__array__"]
            else:
                indexes[name] = _reconstruct(meta["class"], arrays,
                                             meta.get("scalars", {}),
                                             meta.get("nested"), device)
        # manifest entries with no array keys at all (scalar-only or
        # nested-only indexes) must still reconstruct
        for name, meta in manifest.items():
            if name not in indexes:
                indexes[name] = _reconstruct(meta["class"], {},
                                             meta.get("scalars", {}),
                                             meta.get("nested"), device)
        # flat foreign npz without hierarchy: expose arrays directly
        for key in data.files:
            if "/" not in key and key != "__manifest__":
                indexes[key] = data[key]
        return indexes
