"""External-id <-> dense-internal-id mapping (the simpleflow design); a
copy of the JAX package's ``ingest/idmap.py``.

Real edge lists label nodes with arbitrary 64-bit integers or strings;
every layout in this system (CSR, PNG, plans, slot pools) wants dense
``[0, n)`` int32.  ``NodeIdMapping`` assigns internal ids in
first-seen order during ingest and persists alongside the plan
``.npz`` so a restarted server maps queries and results without
re-reading the edge list.

Internal ids here are the graph's ORIGINAL dense ids — the plan
layer's locality relabeling (``PlanConfig.reorder``) is a second,
invisible layer below this one; nothing in this module ever sees it.
"""
from __future__ import annotations

import json

import numpy as np

INT32_MAX = np.iinfo(np.int32).max


class NodeIdMapping:
    """Bidirectional external <-> dense int32 internal node ids.

    External ids are python ints (any 64-bit value) or strings; one
    mapping holds exactly one kind.  ``map_chunk`` grows the mapping
    (ingest side); ``to_internal``/``to_external`` translate without
    growing (query/result side).
    """

    def __init__(self):
        self._ids: dict = {}          # external -> internal (dense)
        self._ext_cache: np.ndarray | None = None

    # ------------------------------------------------------------ views
    @property
    def num_nodes(self) -> int:
        return len(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, ext) -> bool:
        return self._normalize(ext) in self._ids

    @property
    def external_ids(self) -> np.ndarray:
        """(n,) array of external ids, indexed by internal id (dict
        insertion order IS assignment order)."""
        if self._ext_cache is None or len(self._ext_cache) != len(self):
            if not self._ids:
                self._ext_cache = np.array([], dtype=np.int64)
            else:
                self._ext_cache = np.array(list(self._ids))
        return self._ext_cache

    @staticmethod
    def _normalize(ext):
        return ext.item() if isinstance(ext, np.generic) else ext

    # ---------------------------------------------------------- mapping
    def map_chunk(self, ext) -> np.ndarray:
        """Translate one chunk of external ids to internal ids,
        ASSIGNING fresh dense ids to unseen externals (int32-bounded —
        >2^31-1 distinct nodes raises instead of wrapping)."""
        ext = np.asarray(ext)
        out = np.empty(ext.shape[0], dtype=np.int32)
        ids = self._ids
        nxt = len(ids)
        for i, e in enumerate(ext.tolist()):
            v = ids.get(e)
            if v is None:
                if nxt > INT32_MAX:
                    raise ValueError(
                        "graph exceeds int32 node capacity "
                        f"({INT32_MAX + 1} distinct ids)")
                v = ids[e] = nxt
                nxt += 1
            out[i] = v
        return out

    def to_internal(self, ext, *, missing: str = "raise") -> np.ndarray:
        """Translate external -> internal WITHOUT growing the mapping.
        ``missing="raise"`` fails on unknown ids; ``missing="mark"``
        returns -1 for them (virtual-link interpretation uses this —
        a filtered neighbour may not be in the graph at all)."""
        if missing not in ("raise", "mark"):
            raise ValueError(f"missing must be 'raise' or 'mark'; got "
                             f"{missing!r}")
        ext = np.asarray(ext)
        scalar = ext.ndim == 0
        out = np.empty(1 if scalar else ext.shape[0], dtype=np.int32)
        ids = self._ids
        it = [ext.item()] if scalar else ext.tolist()
        for i, e in enumerate(it):
            v = ids.get(e)
            if v is None:
                if missing == "raise":
                    raise KeyError(f"unknown external id {e!r}")
                v = -1
            out[i] = v
        return out[0] if scalar else out

    def to_external(self, internal) -> np.ndarray:
        """Translate internal ids -> external labels (vectorized)."""
        return self.external_ids[np.asarray(internal)]

    @classmethod
    def identity(cls, n: int) -> "NodeIdMapping":
        """The trivial mapping for graphs already labeled 0..n-1
        (synthetic generators) — lets code paths stay uniform."""
        m = cls()
        m._ids = {i: i for i in range(n)}
        return m

    # ---------------------------------------------------- serialization
    def save(self, path: str) -> None:
        """One ``.npz`` next to the plan file: the external-id array
        (int64 or unicode) is the whole state."""
        meta = {"version": 1, "num_nodes": self.num_nodes}
        np.savez_compressed(path, __meta__=json.dumps(meta),
                            external=self.external_ids)

    @classmethod
    def load(cls, path: str) -> "NodeIdMapping":
        z = np.load(path, allow_pickle=False)
        if "__meta__" not in z or "external" not in z:
            raise ValueError(f"{path!r} is not a NodeIdMapping file")
        meta = json.loads(str(z["__meta__"]))
        if meta.get("version") != 1:
            raise ValueError(f"unsupported NodeIdMapping version "
                             f"{meta.get('version')!r} in {path!r}")
        ext = z["external"]
        m = cls()
        m._ids = {e: i for i, e in enumerate(ext.tolist())}
        if len(m._ids) != int(meta["num_nodes"]):
            raise ValueError(
                f"{path!r} is corrupt: {len(m._ids)} distinct external "
                f"ids for {meta['num_nodes']} declared nodes")
        return m
