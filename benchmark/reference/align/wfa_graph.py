"""Graph-WFA: POA-style variant DAG + edit-distance wavefront alignment.

Re-design of the reference's novel SV/TR allele-assignment core
(ref: src/wfa_graph.rs). A phase window's reference backbone is segmented
into nodes with allele branch nodes between them; a read is aligned by an
edit-distance WFA whose wavefronts live per (node, diagonal), and ties union
their traversal sets — a variant touched with both alleles downstream
becomes Ambiguous.

Traversal sets are arbitrary-precision int bitmasks (cheap unions,
hashable for interning). Host implementation; the dense banded device
formulation batches per-read alignments via `hiphase_tpu.ops`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

from reference.core.variants import Variant

USIZE_MAX = 2**63 - 1


class WFAGraphError(Exception):
    """Max edit distance reached during WFA solving."""

    def __init__(self, distance: int):
        super().__init__(
            f"Max_edit_distance ({distance}) reached during WFA solving")
        self.distance = distance


@dataclass
class WFAResult:
    score: int
    traversed_nodes: list[int]


class WFAGraph:
    """DAG of sequence nodes; parents must precede children, single root,
    last node is the alignment target (ref: wfa_graph.rs:61-331)."""

    def __init__(self, max_edit_distance: int = 1000):
        self.sequences: list[bytes] = []
        self.parents: list[list[int]] = []
        self.edges: list[list[int]] = []
        self.max_edit_distance = max_edit_distance

    @property
    def num_nodes(self) -> int:
        return len(self.sequences)

    def add_node(self, sequence: bytes, parent_nodes: list[int]) -> int:
        new_index = len(self.sequences)
        if new_index == 0:
            if parent_nodes:
                raise ValueError("First node must have no parent nodes.")
        else:
            if not parent_nodes:
                raise ValueError(
                    "All nodes after the first must have at least one parent node.")
            if any(p >= new_index for p in parent_nodes):
                raise ValueError("All parent nodes must come before this node.")
        for p in parent_nodes:
            self.edges[p].append(new_index)
        self.sequences.append(bytes(sequence))
        self.parents.append(sorted(parent_nodes))
        self.edges.append([])
        return new_index

    # ---- construction from variants (ref: wfa_graph.rs:119-284) ----

    @classmethod
    def from_reference_variants(cls, reference: bytes, variants: list[Variant],
                                ref_start: int, ref_end: int,
                                max_edit_distance: int = 1000):
        return cls.from_reference_variants_with_hom(
            reference, variants, [], ref_start, ref_end, max_edit_distance)

    @classmethod
    def from_reference_variants_with_hom(cls, reference: bytes,
                                         variants: list[Variant],
                                         hom_variants: list[Variant],
                                         ref_start: int, ref_end: int,
                                         max_edit_distance: int = 1000):
        """Build the window graph. Returns (graph, node_to_alleles) where
        node_to_alleles maps node index → [(variant_index, allele 0|1)].
        Hom variants get branch nodes but no allele mapping.

        Routed through the native C++ builder when available (the Python
        body below is the spec/fallback)."""
        from reference.io import native
        import numpy as np

        if native.available():
            all_variants = [(v, i) for i, v in enumerate(variants)
                            if not v.is_ignored] + \
                           [(v, -1) for v in hom_variants if not v.is_ignored]
            all_variants.sort(key=lambda t: t[0].position)
            n = len(all_variants)
            var_pos = np.fromiter((v.position for v, _ in all_variants),
                                  np.int64, n)
            var_ref_len = np.fromiter((v.ref_len for v, _ in all_variants),
                                      np.int64, n)
            var_index = np.fromiter((i for _, i in all_variants), np.int32, n)
            a0_is_alt = np.fromiter((v.index_allele0 != 0
                                     for v, _ in all_variants), np.uint8, n)
            chunks = []
            a0_off = np.zeros(n, np.int64)
            a0_len = np.zeros(n, np.int64)
            a1_off = np.zeros(n, np.int64)
            a1_len = np.zeros(n, np.int64)
            off = 0
            for k, (v, _) in enumerate(all_variants):
                t0 = v.get_truncated_allele0()
                t1 = v.get_truncated_allele1()
                a0_off[k] = off
                a0_len[k] = len(t0)
                chunks.append(t0)
                off += len(t0)
                a1_off[k] = off
                a1_len[k] = len(t1)
                chunks.append(t1)
                off += len(t1)
            a_blob = np.frombuffer(b"".join(chunks), np.uint8) if off else \
                np.zeros(1, np.uint8)
            out = native.wfa_build(reference, ref_start, ref_end, var_pos,
                                   var_ref_len, var_index, a0_is_alt, a_blob,
                                   a0_off, a0_len, a1_off, a1_len)
            if out is not None:
                node_off, node_blob, edge_off, edge_dst, alleles = out
                graph = cls(max_edit_distance)
                n_nodes = len(node_off) - 1
                blob = node_blob.tobytes()
                graph.sequences = [blob[node_off[i]:node_off[i + 1]]
                                   for i in range(n_nodes)]
                graph.edges = [
                    [int(d) for d in edge_dst[edge_off[i]:edge_off[i + 1]]]
                    for i in range(n_nodes)]
                graph.parents = [[] for _ in range(n_nodes)]
                for p in range(n_nodes):
                    for c in graph.edges[p]:
                        graph.parents[c].append(p)
                node_to_alleles: dict[int, list[tuple[int, int]]] = {}
                an, av, aa = alleles
                for k in range(len(an)):
                    node_to_alleles.setdefault(int(an[k]), []).append(
                        (int(av[k]), int(aa[k])))
                return graph, node_to_alleles
        return cls._from_reference_variants_python(
            reference, variants, hom_variants, ref_start, ref_end,
            max_edit_distance)

    @classmethod
    def _from_reference_variants_python(cls, reference: bytes,
                                        variants: list[Variant],
                                        hom_variants: list[Variant],
                                        ref_start: int, ref_end: int,
                                        max_edit_distance: int = 1000):
        """Python spec for the window-graph construction."""
        graph = cls(max_edit_distance)
        node_to_alleles: dict[int, list[tuple[int, int]]] = {}

        previous_end = ref_start
        reference_reconnect: list[int] = []
        reference_alleles: list[tuple[int, int]] = []
        # min-heap of (reconnect position, insertion order, node index)
        reconnect_queue: list[tuple[int, int, int]] = []
        push_counter = 0

        all_variants: list[tuple[Variant, int | None]] = \
            [(v, i) for i, v in enumerate(variants)] + \
            [(v, None) for v in hom_variants]
        all_variants.sort(key=lambda t: t[0].position)

        def flush_reference_alleles(node_index: int) -> None:
            nonlocal reference_alleles
            if reference_alleles:
                node_to_alleles[node_index] = reference_alleles
                reference_alleles = []

        def drain_reconnects(limit: int) -> None:
            """Process queued branch reconnections at positions ≤ limit."""
            nonlocal previous_end, reference_reconnect
            while reconnect_queue and reconnect_queue[0][0] <= limit:
                alt_reconnect, _, alt_index = heapq.heappop(reconnect_queue)
                assert alt_reconnect > previous_end
                ref_index = graph.add_node(
                    reference[previous_end:alt_reconnect], reference_reconnect)
                flush_reference_alleles(ref_index)
                previous_end = alt_reconnect
                reference_reconnect = [ref_index, alt_index]
                while reconnect_queue and reconnect_queue[0][0] == alt_reconnect:
                    _, _, ai2 = heapq.heappop(reconnect_queue)
                    reference_reconnect.append(ai2)

        for variant, variant_index in all_variants:
            if variant.is_ignored:
                continue
            variant_pos = variant.position
            ref_len = variant.ref_len
            if variant_pos < ref_start:
                continue
            if variant_pos + ref_len > ref_end:
                continue

            drain_reconnects(variant_pos)

            if previous_end < variant_pos or graph.num_nodes == 0:
                ref_index = graph.add_node(
                    reference[previous_end:variant_pos], reference_reconnect)
                flush_reference_alleles(ref_index)
                reference_reconnect = [ref_index]
                previous_end = variant_pos
            else:
                assert previous_end == variant_pos

            # allele0 branch only when it is itself an ALT (multi-allelic)
            if variant.index_allele0 != 0:
                alt_index = graph.add_node(variant.get_truncated_allele0(),
                                           list(reference_reconnect))
                if variant_index is not None:
                    node_to_alleles[alt_index] = [(variant_index, 0)]
                heapq.heappush(reconnect_queue,
                               (variant_pos + ref_len, push_counter, alt_index))
                push_counter += 1
            elif variant_index is not None:
                # reference-allele observation rides the next reference node
                reference_alleles.append((variant_index, 0))

            # allele1 is always a branch
            alt_index = graph.add_node(variant.get_truncated_allele1(),
                                       list(reference_reconnect))
            if variant_index is not None:
                node_to_alleles[alt_index] = [(variant_index, 1)]
            heapq.heappush(reconnect_queue,
                           (variant_pos + ref_len, push_counter, alt_index))
            push_counter += 1

        drain_reconnects(USIZE_MAX)
        assert previous_end <= ref_end
        graph.add_node(reference[previous_end:ref_end], reference_reconnect)
        assert not reference_alleles
        return graph, node_to_alleles

    # ---- alignment (ref: wfa_graph.rs:350-650) ----

    def edit_distance(self, other_sequence: bytes) -> WFAResult:
        return self.edit_distance_with_pruning(other_sequence, USIZE_MAX)

    def edit_distance_with_pruning(self, other_sequence: bytes,
                                   prune_distance: int) -> WFAResult:
        """Edit-distance WFA over the graph (native C++ kernel when built;
        the pure-Python implementation below is the fallback and spec)."""
        from reference.io import native
        import numpy as np

        if native.available():
            node_off = np.zeros(self.num_nodes + 1, dtype=np.int64)
            for i, s in enumerate(self.sequences):
                node_off[i + 1] = node_off[i] + len(s)
            node_blob = np.frombuffer(b"".join(self.sequences), dtype=np.uint8) \
                if node_off[-1] else np.zeros(1, dtype=np.uint8)
            edge_off = np.zeros(self.num_nodes + 1, dtype=np.int64)
            for i, e in enumerate(self.edges):
                edge_off[i + 1] = edge_off[i] + len(e)
            edge_dst = np.fromiter(
                (d for e in self.edges for d in e), dtype=np.int32,
                count=int(edge_off[-1]))
            out = native.wfa_align(node_blob, node_off, edge_dst, edge_off,
                                   other_sequence,
                                   min(prune_distance, USIZE_MAX),
                                   min(self.max_edit_distance, USIZE_MAX))
            if out is not None:
                score, traversed = out
                if score < 0:
                    raise WFAGraphError(self.max_edit_distance)
                return WFAResult(score, [int(i) for i in
                                         np.flatnonzero(traversed)])
        return self._edit_distance_python(other_sequence, prune_distance)

    def _edit_distance_python(self, other_sequence: bytes,
                              prune_distance: int) -> WFAResult:
        """Edit-distance WFA over the graph with traversal-set tracking.

        Wavefronts are per (node, diagonal ``other_start``); greedy match
        extension; dominated offsets dropped via a per-diagonal best memo;
        ties union traversal bitmasks. Lagging wavefronts beyond
        ``prune_distance`` of the farthest progression are dropped."""
        n_nodes = self.num_nodes
        seq = bytes(other_sequence)
        other_len = len(seq)

        # traversal sets interned as int bitmasks
        set_to_index: dict[int, int] = {1 << 0: 0}
        index_to_set: list[int] = [1 << 0]

        def intern(mask: int) -> int:
            idx = set_to_index.get(mask)
            if idx is None:
                idx = len(index_to_set)
                index_to_set.append(mask)
                set_to_index[mask] = idx
            return idx

        # node → {other_start → [(offset, set_index)]}
        active: dict[int, dict[int, list[tuple[int, int]]]] = {
            0: {0: [(0, 0)]}}
        nxt: dict[int, dict[int, list[tuple[int, int]]]] = {}
        # node → {other_start → best offset seen}
        max_wavefronts: dict[int, dict[int, int]] = {}

        edit_distance = 0
        farthest_progression = 0
        min_progression = 0

        while True:
            for node_index in range(n_nodes):
                wavefront = active.pop(node_index, None)
                if wavefront is None:
                    continue
                node_sequence = self.sequences[node_index]
                node_length = len(node_sequence)
                maxfront = max_wavefronts.setdefault(node_index, {})

                for other_start, vec_waves in wavefront.items():
                    # greedy extension along matches
                    max_offset = 0
                    extended = []
                    for offset, set_index in vec_waves:
                        other_position = other_start + offset
                        assert other_position >= 0
                        while (offset < node_length
                               and other_position < other_len
                               and node_sequence[offset] == seq[other_position]):
                            offset += 1
                            other_position += 1
                        extended.append((offset, set_index))
                        if offset > max_offset:
                            max_offset = offset
                    # write back: the final-node check below reads the
                    # post-extension offsets (the reference extends in place)
                    wavefront[other_start] = extended

                    prev_best = maxfront.get(other_start, 0)
                    if (max_offset < prev_best
                            or other_start + max_offset < min_progression):
                        continue  # dominated or pruned
                    maxfront[other_start] = max_offset
                    progression = other_start + max_offset
                    assert progression >= 0
                    if progression > farthest_progression:
                        farthest_progression = progression

                    # collapse ties at the best offset, unioning their sets
                    best_sets = sorted({s for o, s in extended if o == max_offset})
                    if len(best_sets) > 1:
                        mask = 0
                        for s in best_sets:
                            mask |= index_to_set[s]
                        best_set = intern(mask)
                    else:
                        best_set = best_sets[0]

                    if max_offset == node_length:
                        if node_index == n_nodes - 1:
                            if other_start + max_offset < other_len:
                                # end of graph but not of read: only the
                                # read-insertion split is valid
                                node_wf = nxt.setdefault(node_index, {})
                                node_wf.setdefault(other_start + 1, []).append(
                                    (max_offset, best_set))
                        else:
                            # copy to successors at ed+0
                            new_offset = other_start + max_offset
                            for succ in self.edges[node_index]:
                                node_wf = active.setdefault(succ, {})
                                mask = index_to_set[best_set] | (1 << succ)
                                node_wf.setdefault(new_offset, []).append(
                                    (0, intern(mask)))
                    else:
                        node_wf = nxt.setdefault(node_index, {})
                        # deletion in read: diagonal −1, offset advances
                        node_wf.setdefault(other_start - 1, []).append(
                            (max_offset + 1, best_set))
                        if other_start + max_offset < other_len:
                            # mismatch: same diagonal, offset +1
                            node_wf.setdefault(other_start, []).append(
                                (max_offset + 1, best_set))
                            # insertion in read: diagonal +1, offset same
                            node_wf.setdefault(other_start + 1, []).append(
                                (max_offset, best_set))

                if node_index == n_nodes - 1:
                    final_sets = sorted({
                        s for other_start, vec_waves in wavefront.items()
                        for o, s in vec_waves
                        if o == node_length and other_start + o == other_len})
                    if final_sets:
                        mask = 0
                        for s in final_sets:
                            mask |= index_to_set[s]
                        traversed = [i for i in range(n_nodes)
                                     if mask & (1 << i)]
                        return WFAResult(edit_distance, traversed)

            edit_distance += 1
            active = nxt
            nxt = {}
            if farthest_progression > prune_distance:
                min_progression = farthest_progression - prune_distance
            if edit_distance > self.max_edit_distance:
                raise WFAGraphError(self.max_edit_distance)
