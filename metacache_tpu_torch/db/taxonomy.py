"""Taxonomy: dense-array representation designed for on-device LCA.

The reference stores taxa in a ``std::set<taxon>`` with pointer-linked
lineages and a mutex-guarded ranked-lineage cache
(src/taxonomy.h:253-806). The TPU design replaces all of that with dense
int32 arrays indexed by *node index* (not NCBI taxid):

  - ``taxid[i]``      NCBI taxon id (negative ids = sequence-level taxa,
                      mirroring src/sketch_database.h:149-150)
  - ``parent[i]``     node index of parent (0 = no parent; node 0 is a
                      reserved null node)
  - ``rank[i]``       rank code 0..21 (see Rank)
  - ``ranked_lineage[i, r]`` node index of the ancestor at rank r
                      (0 = none) for r in 0..20 (Sequence..root) —
                      the device-side LCA table
  - ``name[i]``       python list (host only)

ranked_lca(a, b) = first r with lineage[a,r] == lineage[b,r] != 0
(src/taxonomy.h:539-546) — on device a vectorized masked-min over 21 lanes.

Construction is NCBI-scale: columns live in geometrically-grown buffers
(`add_node` is amortized O(1)), and `bulk_add` ingests whole nodes.dmp
arrays with vectorized dedup/update semantics so the full ~2.4M-node NCBI
tree builds in seconds (the reference parses it into a std::set,
src/taxonomy_io.cpp:56-181).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Rank:
    """Rank codes, identical ordering to the reference enum
    (src/taxonomy.h:59-84)."""
    SEQUENCE = 0
    FORM = 1
    VARIETY = 2
    SUBSPECIES = 3
    SPECIES = 4
    SUBGENUS = 5
    GENUS = 6
    SUBTRIBE = 7
    TRIBE = 8
    SUBFAMILY = 9
    FAMILY = 10
    SUBORDER = 11
    ORDER = 12
    SUBCLASS = 13
    CLASS = 14
    SUBPHYLUM = 15
    PHYLUM = 16
    SUBKINGDOM = 17
    KINGDOM = 18
    DOMAIN = 19
    ROOT = 20
    NONE = 21

    NUM_RANKS = 21  # number of real ranks (Sequence..root inclusive = 0..20)


_RANK_NAMES = [
    "sequence", "form", "variety", "subspecies", "species", "subgenus",
    "genus", "subtribe", "tribe", "subfamily", "family", "suborder", "order",
    "subclass", "class", "subphylum", "phylum", "subkingdom", "kingdom",
    "domain", "root", "none",
]

# NCBI rank-name -> code (src/taxonomy.h:174-224 rank_from_name)
_NAME_TO_RANK: Dict[str, int] = {
    "sequence": Rank.SEQUENCE, "genome": Rank.SEQUENCE,
    "form": Rank.FORM, "forma": Rank.FORM,
    "variety": Rank.VARIETY, "varietas": Rank.VARIETY,
    "subspecies": Rank.SUBSPECIES,
    "species": Rank.SPECIES,
    "species group": Rank.SUBGENUS, "species subgroup": Rank.SUBGENUS,
    "subgenus": Rank.SUBGENUS,
    "genus": Rank.GENUS,
    "subtribe": Rank.SUBTRIBE,
    "tribe": Rank.TRIBE,
    "subfamily": Rank.SUBFAMILY,
    "family": Rank.FAMILY,
    "superfamily": Rank.SUBORDER, "parvorder": Rank.SUBORDER,
    "infraorder": Rank.SUBORDER, "suborder": Rank.SUBORDER,
    "order": Rank.ORDER,
    "superorder": Rank.SUBCLASS, "infraclass": Rank.SUBCLASS,
    "subclass": Rank.SUBCLASS,
    "class": Rank.CLASS,
    "superclass": Rank.SUBPHYLUM, "subphylum": Rank.SUBPHYLUM,
    "phylum": Rank.PHYLUM, "division": Rank.PHYLUM,
    "superphylum": Rank.SUBKINGDOM, "subkingdom": Rank.SUBKINGDOM,
    "kingdom": Rank.KINGDOM, "subdomain": Rank.KINGDOM,
    "superkingdom": Rank.DOMAIN, "domain": Rank.DOMAIN,
    "root": Rank.ROOT,
}


def rank_from_name(name: str) -> int:
    return _NAME_TO_RANK.get(name.strip().lower(), Rank.NONE)


def rank_name(code: int) -> str:
    if 0 <= code < len(_RANK_NAMES):
        return _RANK_NAMES[code]
    return "none"


NONE_TAXID = 0  # taxonomy::none_id


def _first_valid_per_group(inv: np.ndarray, values: np.ndarray,
                           valid: np.ndarray, default,
                           num_groups: int) -> np.ndarray:
    """For each group g, the first `values[i]` (in occurrence order) with
    `valid[i]` among occurrences i where inv[i]==g; `default` if none.

    Implemented as a reversed fancy-index scatter: later assignments win in
    numpy fancy indexing, so scattering in reverse occurrence order leaves
    the EARLIEST valid occurrence in each slot.
    """
    out = np.full(num_groups, default, dtype=values.dtype)
    sel = valid[::-1]
    out[inv[::-1][sel]] = values[::-1][sel]
    return out


class Taxonomy:
    """Dense taxonomy. Node 0 is the reserved null node."""

    GROW = 2  # geometric buffer growth factor

    def __init__(self):
        self._n = 1
        self._taxid = np.zeros(1, dtype=np.int64)   # NCBI id (neg = sequence)
        self._parent = np.zeros(1, dtype=np.int64)
        self._rank = np.full(1, Rank.NONE, dtype=np.int8)
        self.names: List[str] = [""]
        # file source info for sequence-level taxa (filename, index, windows)
        self.source_filename: List[str] = [""]
        self._src_index = np.zeros(1, dtype=np.int64)
        self._src_windows = np.zeros(1, dtype=np.int64)
        self._id2node: Dict[int, int] = {}
        self._lineage_cache: Optional[np.ndarray] = None
        self._covered_cache: Optional[np.ndarray] = None

    # ------------------------------------------------------------- columns
    # Columns are views into geometrically grown buffers; in-place writes
    # (e.g. tax.rank[n] = Rank.ROOT) hit the buffer directly.
    @property
    def taxid(self) -> np.ndarray:
        return self._taxid[:self._n]

    @property
    def parent_taxid(self) -> np.ndarray:
        return self._parent[:self._n]

    @property
    def rank(self) -> np.ndarray:
        return self._rank[:self._n]

    @property
    def source_index(self) -> np.ndarray:
        return self._src_index[:self._n]

    @property
    def source_windows(self) -> np.ndarray:
        return self._src_windows[:self._n]

    def invalidate_caches(self) -> None:
        self._lineage_cache = None
        self._covered_cache = None

    def _ensure_capacity(self, extra: int) -> None:
        need = self._n + extra
        cap = len(self._taxid)
        if need <= cap:
            return
        new_cap = max(need, cap * self.GROW)

        def grow(buf):
            out = np.zeros(new_cap, dtype=buf.dtype)
            out[:self._n] = buf[:self._n]
            return out

        self._taxid = grow(self._taxid)
        self._parent = grow(self._parent)
        new_rank = np.full(new_cap, Rank.NONE, dtype=np.int8)
        new_rank[:self._n] = self._rank[:self._n]
        self._rank = new_rank
        self._src_index = grow(self._src_index)
        self._src_windows = grow(self._src_windows)

    # ------------------------------------------------------------------ build
    def add_node(self, taxid: int, parent_taxid: int, name: str,
                 rank_code: int, source_filename: str = "",
                 source_index: int = 0, source_windows: int = 0) -> int:
        """Insert or update a node; returns its node index.

        Mirrors taxonomy::emplace semantics: an existing id keeps its node;
        re-adding updates fields that were previously unset.
        """
        node = self._id2node.get(taxid)
        if node is not None:
            if rank_code != Rank.NONE and self._rank[node] == Rank.NONE:
                self._rank[node] = rank_code
            if parent_taxid != NONE_TAXID and \
                    self._parent[node] == NONE_TAXID:
                self._parent[node] = parent_taxid
            if name and not self.names[node]:
                self.names[node] = name
            self.invalidate_caches()
            return node
        self._ensure_capacity(1)
        node = self._n
        self._taxid[node] = taxid
        self._parent[node] = parent_taxid
        self._rank[node] = rank_code
        self.names.append(name)
        self.source_filename.append(source_filename)
        self._src_index[node] = source_index
        self._src_windows[node] = source_windows
        self._n += 1
        self._id2node[taxid] = node
        self.invalidate_caches()
        return node

    def bulk_add(self, taxids, parents, names, ranks) -> None:
        """Vectorized batch insert with add_node semantics.

        Per unique id, the first occurrence creates the node; later
        occurrences (in the batch or vs pre-existing nodes) only fill
        fields that are still unset. Handles the full NCBI nodes.dmp
        (~2.4M rows) in well under a second (vs O(n^2) per-row appends).
        """
        ids = np.asarray(taxids, dtype=np.int64)
        if ids.size == 0:
            return
        pars = np.asarray(parents, dtype=np.int64)
        rks = np.asarray(ranks, dtype=np.int8)
        names_arr = np.asarray(list(names), dtype=object)

        # in-batch dedup: for each unique id pick the first valid value of
        # each field in occurrence order
        uniq, first_idx, inv = np.unique(ids, return_index=True,
                                         return_inverse=True)
        g = uniq.size
        u_par = _first_valid_per_group(inv, pars, pars != NONE_TAXID,
                                       NONE_TAXID, g)
        u_rank = _first_valid_per_group(inv, rks, rks != Rank.NONE,
                                        Rank.NONE, g)
        has_name = np.array([bool(x) for x in names_arr], dtype=bool)
        u_name = _first_valid_per_group(inv, names_arr, has_name, "", g)

        # split into pre-existing vs new ids
        existing_nodes = np.array(
            [self._id2node.get(int(t), -1) for t in uniq], dtype=np.int64)
        is_new = existing_nodes < 0

        # update unset fields of pre-existing nodes
        ex_nodes = existing_nodes[~is_new]
        if ex_nodes.size:
            ex_rank = u_rank[~is_new]
            upd = (ex_rank != Rank.NONE) & (self._rank[ex_nodes] == Rank.NONE)
            self._rank[ex_nodes[upd]] = ex_rank[upd]
            ex_par = u_par[~is_new]
            upd = (ex_par != NONE_TAXID) & \
                (self._parent[ex_nodes] == NONE_TAXID)
            self._parent[ex_nodes[upd]] = ex_par[upd]
            ex_name = u_name[~is_new]
            for node, nm in zip(ex_nodes, ex_name):
                if nm and not self.names[node]:
                    self.names[node] = nm

        # append all new ids en masse
        new_ids = uniq[is_new]
        k = new_ids.size
        if k:
            self._ensure_capacity(k)
            lo, hi = self._n, self._n + k
            self._taxid[lo:hi] = new_ids
            self._parent[lo:hi] = u_par[is_new]
            self._rank[lo:hi] = u_rank[is_new]
            self.names.extend(u_name[is_new].tolist())
            self.source_filename.extend([""] * k)
            self._n = hi
            self._id2node.update(
                zip(new_ids.tolist(), range(lo, hi)))
        self.invalidate_caches()

    # ------------------------------------------------------------------ query
    def __len__(self) -> int:
        return self._n

    def node_of_id(self, taxid: int) -> int:
        """Node index for an NCBI taxid, 0 if unknown."""
        return self._id2node.get(taxid, 0)

    def parent_node(self, node: int) -> int:
        return self.node_of_id(int(self._parent[node]))

    def lineage_nodes(self, node: int) -> List[int]:
        """Full lineage node indices starting at `node` (src/taxonomy.h:600-625)."""
        out = []
        seen = set()
        while node != 0 and node not in seen:
            out.append(node)
            seen.add(node)
            node = self.parent_node(node)
        return out

    @property
    def ranked_lineage(self) -> np.ndarray:
        """[num_nodes, 21] int32 node index of ancestor at each rank (0=none).

        Rebuilt lazily after modifications — the dense analogue of
        ranked_lineages_cache (src/taxonomy.h:702-806). Built by pointer
        jumping: one vectorized pass per tree level (NCBI depth ~40).
        """
        if self._lineage_cache is None:
            n = self._n
            lin = np.zeros((n, Rank.NUM_RANKS), dtype=np.int32)
            parent_node = self._parent_node_array()
            cur = np.arange(n, dtype=np.int32)
            cur[0] = 0
            nodes = np.arange(n, dtype=np.int32)
            rank = self.rank
            for _ in range(n + 1):
                active = cur != 0
                if not active.any():
                    break
                # shrink to the still-walking subset: each level only a
                # fraction of lineages is unfinished
                nodes = nodes[active]
                cur = cur[active]
                r = rank[cur]
                place = r < Rank.NUM_RANKS
                lin[nodes[place], r[place].astype(np.int64)] = cur[place]
                nxt = parent_node[cur]
                cur = np.where(nxt == cur, 0, nxt)  # break self-cycles
            self._lineage_cache = lin
        return self._lineage_cache

    def _parent_node_array(self) -> np.ndarray:
        """[num_nodes] int32: node index of each node's parent (0 if none)."""
        taxid = self.taxid
        parent_taxid = self.parent_taxid
        order = np.argsort(taxid, kind="stable")
        sorted_ids = taxid[order]
        pos = np.searchsorted(sorted_ids, parent_taxid)
        pos = np.clip(pos, 0, len(sorted_ids) - 1)
        found = sorted_ids[pos] == parent_taxid
        pnode = np.where(found, order[pos], 0).astype(np.int32)
        pnode[parent_taxid == NONE_TAXID] = 0
        pnode[0] = 0
        return pnode

    def ranks_of(self, node: int) -> np.ndarray:
        return self.ranked_lineage[node]

    def ranked_lca_node(self, a: int, b: int) -> int:
        """First common entry of the two ranked lineages
        (src/taxonomy.h:539-546). Returns node index, 0 if none."""
        if a == 0 or b == 0:
            return 0
        la, lb = self.ranked_lineage[a], self.ranked_lineage[b]
        eq = (la == lb) & (la != 0)
        idx = np.nonzero(eq)[0]
        return int(la[idx[0]]) if len(idx) else 0

    def ancestor_at_rank(self, node: int, rank_code: int) -> int:
        """Ancestor on exactly `rank_code`, 0 if none (taxonomy::ancestor)."""
        if node == 0 or rank_code >= Rank.NUM_RANKS:
            return 0
        return int(self.ranked_lineage[node, rank_code])

    def next_ranked_ancestor(self, node: int) -> int:
        """`node` itself if ranked, else closest ranked ancestor
        (src/taxonomy.h:549-576)."""
        while node != 0:
            if self._rank[node] != Rank.NONE:
                return node
            parent = self.parent_node(node)
            if parent == node:
                return 0
            node = parent
        return 0

    @property
    def covered_mask(self) -> np.ndarray:
        """[num_nodes] bool: node lies on the lineage of some sequence-level
        taxon (vectorized sketch_database::covers,
        src/sketch_database.h:791-800). Built once by walking all
        sequence-level lineages up in lock-step."""
        if self._covered_cache is None:
            covered = np.zeros(self._n, dtype=bool)
            pn = self._parent_node_array()
            cur = np.nonzero(self.rank == Rank.SEQUENCE)[0]
            while cur.size:
                fresh = cur[~covered[cur]]
                if fresh.size == 0:
                    break
                covered[fresh] = True
                cur = np.unique(pn[fresh])
                cur = cur[cur != 0]
            covered[0] = False
            self._covered_cache = covered
        return self._covered_cache

    def covers_node(self, node: int) -> bool:
        """True if `node` lies on the lineage of any sequence-level taxon
        (sketch_database::covers, src/sketch_database.h:791-800)."""
        if node <= 0 or node >= self._n:
            return False
        return bool(self.covered_mask[node])

    # ------------------------------------------------------------- serialize
    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "taxid": self.taxid.copy(),
            "parent_taxid": self.parent_taxid.copy(),
            "rank": self.rank.copy(),
            "names": np.array(self.names, dtype=object),
            "source_filename": np.array(self.source_filename, dtype=object),
            "source_index": self.source_index.copy(),
            "source_windows": self.source_windows.copy(),
        }

    @classmethod
    def from_arrays(cls, arrs: Dict[str, np.ndarray]) -> "Taxonomy":
        t = cls()
        t._taxid = np.asarray(arrs["taxid"], dtype=np.int64).copy()
        t._parent = np.asarray(arrs["parent_taxid"], dtype=np.int64).copy()
        t._rank = np.asarray(arrs["rank"], dtype=np.int8).copy()
        t.names = [str(x) for x in arrs["names"]]
        t.source_filename = [str(x) for x in arrs["source_filename"]]
        t._src_index = np.asarray(arrs["source_index"], dtype=np.int64).copy()
        t._src_windows = np.asarray(arrs["source_windows"],
                                    dtype=np.int64).copy()
        t._n = len(t._taxid)
        t._id2node = {int(tid): i
                      for i, tid in enumerate(t._taxid[:t._n]) if i != 0}
        t.invalidate_caches()
        return t
