"""Padded, static-shape batch container — the replacement for
PyG ``Data`` + ``collate_fn`` (reference fragnet/dataset/data.py:877-948).

Molecules are concatenated with cumulative index offsets exactly like the
reference collate, then padded to a ``PadSpec``. Padding convention:
  * pad edges carry index 0 and mask 0 — the model masks their softmax
    logits and zeroes their probabilities, so the pointed-at segment is
    never polluted;
  * pad atoms/frags carry zero features and segment id 0 — the model zeroes
    masked node states before any pooling, so segment 0 receives only zeros;
  * y rows for pad graphs are zero and ``graph_mask`` excludes them from
    losses/metrics.

All fields are numpy here; graphs/batch.py moves them to a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class HierGraphBatch:
    # atom graph
    x_atoms: np.ndarray          # (A, 167) f32
    edge_src: np.ndarray         # (E,) i32
    edge_dst: np.ndarray         # (E,) i32
    edge_attr: np.ndarray        # (E, 17) f32
    atom_mask: np.ndarray        # (A,) f32
    edge_mask: np.ndarray        # (E,) f32
    # bond line graph (nodes == directed atom-graph edges)
    nf_bonds: np.ndarray         # (E, 17) f32
    bg_src: np.ndarray           # (EB,) i32
    bg_dst: np.ndarray           # (EB,) i32
    ea_bonds: np.ndarray         # (EB, 1) f32
    bg_mask: np.ndarray          # (EB,) f32
    # fragment graph
    x_frags: np.ndarray          # (F, 167) f32
    frag_src: np.ndarray         # (C,) i32
    frag_dst: np.ndarray         # (C,) i32
    cnx_attr: np.ndarray         # (C, 6) f32
    frag_mask: np.ndarray        # (F,) f32
    fconn_mask: np.ndarray       # (C,) f32
    # fragment-connection line graph (nodes == directed connections)
    nf_fbonds: np.ndarray        # (C, 6) f32
    fc_src: np.ndarray           # (EC,) i32
    fc_dst: np.ndarray           # (EC,) i32
    ea_fbonds: np.ndarray        # (EC, 6) f32
    fc_mask: np.ndarray          # (EC,) f32
    # hierarchy couplings + pooling segments
    atom_to_frag: np.ndarray     # (A,) i32
    atom_batch: np.ndarray       # (A,) i32
    frag_batch: np.ndarray       # (F,) i32
    # labels
    y: np.ndarray                # (G, n_tasks) f32
    graph_mask: np.ndarray       # (G,) f32
    # optional pretrain targets
    bnd_lngth: Optional[np.ndarray] = None   # (E, 1)
    bnd_angl: Optional[np.ndarray] = None    # (A, 1)
    dh_angl: Optional[np.ndarray] = None     # (E, 1)
    # optional task extras
    protein: Optional[np.ndarray] = None     # (G, seq_len) i32
    gene_expr: Optional[np.ndarray] = None   # (G, n_genes) f32
    # optional ELL neighbor tables (ops/ell.py) — dense bounded-degree
    # formulation; atom tables index the EXTENDED edge array where id E+i is
    # atom i's self-loop
    atom_nbr_edge: Optional[np.ndarray] = None  # (A, Ka) i32
    atom_nbr_mask: Optional[np.ndarray] = None  # (A, Ka) f32
    bg_nbr_edge: Optional[np.ndarray] = None    # (E, Kb) i32
    bg_nbr_mask: Optional[np.ndarray] = None    # (E, Kb) f32
    frag_nbr_edge: Optional[np.ndarray] = None  # (F, Kf) i32
    frag_nbr_mask: Optional[np.ndarray] = None  # (F, Kf) f32
    fc_nbr_edge: Optional[np.ndarray] = None    # (C, Kc) i32
    fc_nbr_mask: Optional[np.ndarray] = None    # (C, Kc) f32
    # optional TCSR tile metadata (ops/tcsr.py) for the fused GAT kernel
    tm_atom: Optional[object] = None
    tm_bond: Optional[object] = None
    tm_frag: Optional[object] = None
    tm_fc: Optional[object] = None
    # optional dense per-tile planes (ops/dense_gat.py) for the zero-gather
    # bond/fconn passes — present only for tile-aligned batches
    dp_bond: Optional[np.ndarray] = None  # (E//tn, 2*tn, tn) f32
    dp_fc: Optional[np.ndarray] = None    # (C//tn, 7*tn, tn) f32
    # adjacency-only planes for the dynamic-edge-attr dense passes
    # (atom / frag levels; ops/dense_gat.py dense_attr_gat_pass)
    dp_atom: Optional[np.ndarray] = None  # (A//tn, tn, tn) f32
    dp_frag: Optional[np.ndarray] = None  # (F//tn, tn, tn) f32

    @property
    def n_graphs(self) -> int:
        return self.y.shape[0]

    @property
    def n_atom_slots(self) -> int:
        return self.x_atoms.shape[0]

    @property
    def n_edge_slots(self) -> int:
        return self.edge_src.shape[0]

    @property
    def n_frag_slots(self) -> int:
        return self.x_frags.shape[0]

    @property
    def n_fconn_slots(self) -> int:
        return self.nf_fbonds.shape[0]


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static capacities per batch. ``n_graphs`` counts molecule slots; the
    others count nodes/edges across the whole packed batch."""

    n_graphs: int
    n_atoms: int
    n_edges: int
    n_frags: int
    n_fconn: int
    n_bg_edges: int
    n_fc_edges: int
    # ELL neighbor-table widths (None disables the dense formulation)
    k_atom: Optional[int] = None
    k_bg: Optional[int] = None
    k_frag: Optional[int] = None
    k_fc: Optional[int] = None
    # TCSR tiling for the fused GAT kernel (ops/tcsr_gat.py): tile sizes
    # plus pinned (n_chunks, k_src) per level so every batch has the same
    # window bounds. None disables the kernel path. The defaults (tn=128,
    # te=256) are the JAX package's; they have not been tuned on the GPU.
    tn: int = 128
    te: int = 256
    tc_atom: Optional[tuple] = None
    tc_bond: Optional[tuple] = None
    tc_frag: Optional[tuple] = None
    tc_fc: Optional[tuple] = None
    # per-axis node-tile overrides (0 = use ``tn``). A dataset whose
    # molecules exceed tn nodes on ONE axis (e.g. esol's ≤244 bond-graph
    # nodes) would otherwise lose tile-locality there — disabling the dense
    # zero-gather kernel and widening the TCSR windows for the WHOLE batch
    # (measured: the bond level alone was ~55% of the esol-profile step).
    # spec_for auto-picks the smallest {128, 256} tile that fits the axis's
    # largest molecule.
    tn_atom: int = 0
    tn_bond: int = 0
    tn_frag: int = 0
    tn_fc: int = 0

    def tn_of(self, level: str) -> int:
        return getattr(self, f"tn_{level}") or self.tn
    # tile-aligned packing: pad each node axis (atoms / bond-nodes / frags /
    # fconn-nodes) so no molecule straddles a tn-node tile. This shrinks the
    # TCSR source windows to k_src=1 AND enables the dense zero-gather
    # bond/fconn kernels (ops/dense_gat.py). Costs ~8-20% more node slots.
    align: bool = False

    @property
    def tcsr(self) -> bool:
        return self.tc_atom is not None

    def round_to(self, multiple: int = 8) -> "PadSpec":
        r = lambda x: ((x + multiple - 1) // multiple) * multiple
        return dataclasses.replace(
            self,
            n_atoms=r(self.n_atoms),
            n_edges=r(self.n_edges),
            n_frags=r(self.n_frags),
            n_fconn=r(self.n_fconn),
            n_bg_edges=r(self.n_bg_edges),
            n_fc_edges=r(self.n_fc_edges),
        )


def _aligned_starts(counts, tn: int) -> np.ndarray:
    """Per-molecule start offsets with tile alignment: a molecule that would
    straddle a tn boundary starts at the next tile (molecules larger than tn
    stay contiguous — the dense path is disabled for them downstream).
    Returns (n+1,) offsets; [-1] is the aligned total."""
    n = len(counts)
    offs = np.zeros((n + 1,), np.int64)
    pos = 0
    for i, cnt in enumerate(counts):
        cnt = int(cnt)
        if cnt <= tn and (pos % tn) + cnt > tn:
            pos = ((pos + tn - 1) // tn) * tn
        offs[i] = pos
        pos += cnt
    offs[n] = pos
    return offs


def _level_counts(graphs):
    """(4, n) per-molecule counts for the four aligned node axes."""
    return [np.fromiter((g.n_atoms for g in graphs), np.int64, len(graphs)),
            np.fromiter((g.n_edges for g in graphs), np.int64, len(graphs)),
            np.fromiter((g.n_frags for g in graphs), np.int64, len(graphs)),
            np.fromiter((g.n_fconn for g in graphs), np.int64, len(graphs))]


def _max_indeg(dst_rows, n_nodes: int) -> int:
    if len(dst_rows) == 0:
        return 0
    return int(np.bincount(np.asarray(dst_rows, dtype=np.int64),
                           minlength=max(n_nodes, 1)).max())


def spec_for(graphs: Sequence, batch_size: int, slack: float = 1.1,
             multiple: int = 8, ell: bool = False,
             tcsr: bool = False, tn: int = 128, te: int = 256,
             align: Optional[bool] = None) -> PadSpec:
    """Compute a PadSpec covering a window of ``batch_size`` graphs from the
    dataset. The bound is the WINDOW-SUM estimate batch_size·mean +
    4·std·√batch_size + 2·max (a shuffled window's total concentrates near
    batch_size·mean; the tail term covers unlucky draws, the max terms cover
    one oversized molecule). The previous batch_size·p95 bound measured
    2.0-2.3× the real window content on every axis (r5 step-anatomy:
    esol bond-line capacity 310k vs ~140k real), and every dense/TCSR kernel's
    cost scales with SLOTS, not real edges — so cap tightness is directly
    edges/s. Overfull windows are handled by the batcher (``fits`` closes a
    batch early and the molecules spill to the next one), so the bound only
    needs to be right on average, not worst-case."""
    if not graphs:
        raise ValueError("empty dataset")
    stats = {
        k: np.array([getattr(g, k) for g in graphs])
        for k in ("n_atoms", "n_edges", "n_frags", "n_fconn", "n_bg_edges", "n_fc_edges")
    }

    def cap(arr: np.ndarray) -> int:
        if batch_size <= 4:
            # tiny batches must fit ANY batch_size molecules (dp/tests)
            return int(arr.max() * min(batch_size, len(arr)))
        est = int(batch_size * arr.mean() * max(slack - 0.1, 1.0)
                  + 4.0 * arr.std() * np.sqrt(batch_size) + 2 * arr.max())
        return est

    ks = {}
    if ell:
        # the ELL (dense neighbor-table) formulation (ops/ell.py): per-level
        # max in-degree across the dataset (+1 atom self-loop). The JAX
        # package measured it ~100x slower than its segment path on a TPU
        # and keeps it opt-in; the port keeps it opt-in too (PERF.md has its
        # times on the GPU)
        ks["k_atom"] = 1 + max(
            _max_indeg(g.edge_index[1], g.n_atoms) for g in graphs
        )
        ks["k_bg"] = max(
            _max_indeg(g.ei_bonds[0], g.n_edges) for g in graphs
        )  # row 0 of ei_bonds is the aggregation target (see pad_batch)
        ks["k_frag"] = max(
            _max_indeg(g.frag_index[1], g.n_frags) for g in graphs
        )
        ks["k_fc"] = max(
            _max_indeg(g.ei_fbonds[0], g.n_fconn) for g in graphs
        )
        ks = {k: max(v, 1) for k, v in ks.items()}

    if align is None:
        align = tcsr  # aligned packing is the TCSR/dense fast path default

    # per-axis node tiles: bump an axis to 256 when its largest molecule
    # exceeds tn (keeps every molecule tile-local → dense kernels + k_src=1
    # stay available); beyond 256 keep tn and let TCSR absorb the stragglers
    axis_of = {"n_atoms": "atom", "n_edges": "bond", "n_frags": "frag",
               "n_fconn": "fc"}
    tns = {}
    for name, lvl in axis_of.items():
        mx = int(stats[name].max())
        tns[f"tn_{lvl}"] = 0 if mx <= tn else (256 if mx <= 256 else 0)
    tn_by_name = {name: (tns[f"tn_{lvl}"] or tn)
                  for name, lvl in axis_of.items()}

    caps = {k: cap(v) for k, v in stats.items()}
    if align:
        # alignment inflates the node axes; measure the waste on probe
        # windows of batch_size molecules and bump the caps to cover it
        names = ("n_atoms", "n_edges", "n_frags", "n_fconn")
        probes = range(0, max(1, len(graphs) - batch_size + 1),
                       max(1, (len(graphs) - batch_size) // 8 or 1))
        for lo in list(probes)[:9]:
            win = graphs[lo:lo + batch_size]
            for name, counts in zip(names, _level_counts(win)):
                tot = int(_aligned_starts(counts, tn_by_name[name])[-1]
                          * slack)
                caps[name] = max(caps[name], tot)

    spec = PadSpec(
        n_graphs=batch_size,
        n_atoms=caps["n_atoms"],
        n_edges=caps["n_edges"],
        n_frags=caps["n_frags"],
        n_fconn=caps["n_fconn"],
        n_bg_edges=caps["n_bg_edges"],
        n_fc_edges=caps["n_fc_edges"],
        tn=tn, te=te, align=align,
        **(tns if (tcsr or align) else {}),
        **ks,
    ).round_to(max(multiple, tn, te, *tn_by_name.values())
               if (tcsr or align) else multiple)
    if not tcsr:
        return spec
    return _pin_tcsr(spec, graphs, batch_size)


def _pin_tcsr(spec: PadSpec, graphs: Sequence, batch_size: int,
              n_probe: int = 8) -> PadSpec:
    """Measure the per-level TCSR window widths over a few probe batches and
    pin them (with one chunk of slack) so every batch compiles identically."""
    from fragnet_tpu_torch.ops.tcsr import build_tile_meta

    maxes = {"atom": [1, 1], "bond": [1, 1], "frag": [1, 1], "fc": [1, 1]}
    i = 0
    probes = 0
    while i < len(graphs) and probes < n_probe:
        win: list = []
        while i < len(graphs) and len(win) < batch_size \
                and fits(win + [graphs[i]], spec):
            win.append(graphs[i])
            i += 1
        if not win:
            i += 1
            continue
        # the probe reads only structure; y as wide as the labels (the JAX
        # package's probe pads one task and raises on multi-task labels)
        b = pad_batch(win, spec, n_tasks=max(np.size(g.y) for g in win))
        probes += 1
        for name, (s, d, m, n) in {
            "atom": (b.edge_src, b.edge_dst, b.edge_mask, spec.n_atoms),
            "bond": (b.bg_src, b.bg_dst, b.bg_mask, spec.n_edges),
            "frag": (b.frag_src, b.frag_dst, b.fconn_mask, spec.n_frags),
            "fc": (b.fc_src, b.fc_dst, b.fc_mask, spec.n_fconn),
        }.items():
            tm = build_tile_meta(s, d, m, n, tn=spec.tn_of(name),
                                 te=spec.te)
            if tm is None:
                return spec  # locality violated — leave the kernel path off
            maxes[name][0] = max(maxes[name][0], tm.n_chunks)
            maxes[name][1] = max(maxes[name][1], tm.k_src)

    # molecules larger than tn nodes at a level cannot be tile-aligned:
    # their edges straddle tiles, so the source window needs one more tile
    # and the chunk window can widen beyond what the probes saw — bump the
    # pins so every shuffle-order batch stays inside them (a too-narrow pin
    # makes build_tile_meta return None mid-stream, which breaks the packed
    # transport's single-compilation contract)
    over = {
        "atom": any(g.n_atoms > spec.tn_of("atom") for g in graphs),
        "bond": any(g.n_edges > spec.tn_of("bond") for g in graphs),
        "frag": any(g.n_frags > spec.tn_of("frag") for g in graphs),
        "fc": any(g.n_fconn > spec.tn_of("fc") for g in graphs),
    }

    def pin(name, n_nodes, n_edges):
        slack_c = 3 if (spec.align and over[name]) else 1
        slack_k = 1 if (spec.align and over[name]) else 0
        c = min(maxes[name][0] + slack_c, n_edges // spec.te)
        k = min(maxes[name][1] + slack_k, n_nodes // spec.tn_of(name))
        return (c, k)

    return dataclasses.replace(
        spec,
        tc_atom=pin("atom", spec.n_atoms, spec.n_edges),
        tc_bond=pin("bond", spec.n_edges, spec.n_bg_edges),
        tc_frag=pin("frag", spec.n_frags, spec.n_fconn),
        tc_fc=pin("fc", spec.n_fconn, spec.n_fc_edges),
    )


def fits(graphs: Sequence, spec: PadSpec) -> bool:
    if len(graphs) > spec.n_graphs \
            or sum(g.n_bg_edges for g in graphs) > spec.n_bg_edges \
            or sum(g.n_fc_edges for g in graphs) > spec.n_fc_edges:
        return False
    caps = (spec.n_atoms, spec.n_edges, spec.n_frags, spec.n_fconn)
    if not spec.align:
        tots = (sum(g.n_atoms for g in graphs),
                sum(g.n_edges for g in graphs),
                sum(g.n_frags for g in graphs),
                sum(g.n_fconn for g in graphs))
        return all(t <= c for t, c in zip(tots, caps))
    lvl_tns = [spec.tn_of(l) for l in ("atom", "bond", "frag", "fc")]
    return all(int(_aligned_starts(counts, t)[-1]) <= c
               for counts, t, c in zip(_level_counts(graphs), lvl_tns, caps))


def pad_batch(graphs: Sequence, spec: PadSpec, n_tasks: int = 1,
              with_targets: bool = False,
              build_dense: bool = True,
              strict_tcsr: bool = False,
              template=None) -> HierGraphBatch:
    """Concatenate molecules with index offsets (collate semantics,
    data.py:877-948) and pad every dimension to the spec.

    ``build_dense=False`` skips the dense value/adjacency planes
    (ops/dense_gat.py) — tens of MB of host np.zeros + scatters per batch
    that the packed-transport path immediately discards (the planes are
    deliberately not transported; data/packing.py). Pack workers MUST pass
    False or host packing throughput craters (ADVICE r4)."""
    if not fits(graphs, spec):
        raise ValueError(
            f"batch exceeds spec: atoms={sum(g.n_atoms for g in graphs)}"
            f"/{spec.n_atoms} edges={sum(g.n_edges for g in graphs)}/{spec.n_edges}"
        )

    G, A, E = spec.n_graphs, spec.n_atoms, spec.n_edges
    F, C = spec.n_frags, spec.n_fconn
    EB, EC = spec.n_bg_edges, spec.n_fc_edges
    ref = graphs[0] if graphs else template
    fd_atom = ref.x_atoms.shape[1]

    x_atoms = np.zeros((A, fd_atom), np.float32)
    edge_src = np.zeros((E,), np.int32)
    edge_dst = np.zeros((E,), np.int32)
    edge_attr = np.zeros((E, ref.edge_attr.shape[1]), np.float32)
    atom_mask = np.zeros((A,), np.float32)
    edge_mask = np.zeros((E,), np.float32)
    nf_bonds = np.zeros((E, ref.nf_bonds.shape[1]), np.float32)
    bg_src = np.zeros((EB,), np.int32)
    bg_dst = np.zeros((EB,), np.int32)
    ea_bonds = np.zeros((EB, 1), np.float32)
    bg_mask = np.zeros((EB,), np.float32)
    x_frags = np.zeros((F, fd_atom), np.float32)
    frag_src = np.zeros((C,), np.int32)
    frag_dst = np.zeros((C,), np.int32)
    cnx_attr = np.zeros((C, 6), np.float32)
    frag_mask = np.zeros((F,), np.float32)
    fconn_mask = np.zeros((C,), np.float32)
    nf_fbonds = np.zeros((C, 6), np.float32)
    fc_src = np.zeros((EC,), np.int32)
    fc_dst = np.zeros((EC,), np.int32)
    ea_fbonds = np.zeros((EC, 6), np.float32)
    fc_mask = np.zeros((EC,), np.float32)
    atom_to_frag = np.zeros((A,), np.int32)
    atom_batch = np.zeros((A,), np.int32)
    frag_batch = np.zeros((F,), np.int32)
    y = np.zeros((G, n_tasks), np.float32)
    graph_mask = np.zeros((G,), np.float32)

    bnd_lngth = np.zeros((E, 1), np.float32) if with_targets else None
    bnd_angl = np.zeros((A, 1), np.float32) if with_targets else None
    dh_angl = np.zeros((E, 1), np.float32) if with_targets else None
    protein = None
    gene_expr = None
    if ref.protein is not None:
        protein = np.zeros((G, ref.protein.shape[-1]), np.int32)
    if ref.gene_expr is not None:
        gene_expr = np.zeros((G, ref.gene_expr.shape[-1]), np.float32)

    # vectorized collate: per-field concatenation + one write into the
    # padded buffer (a per-graph × per-field Python assignment loop was the
    # batch-prep hotspot; same values, C-speed copies)
    n = len(graphs)
    na = np.fromiter((g.n_atoms for g in graphs), np.int64, n)
    ne = np.fromiter((g.n_edges for g in graphs), np.int64, n)
    nf = np.fromiter((g.n_frags for g in graphs), np.int64, n)
    nc = np.fromiter((g.n_fconn for g in graphs), np.int64, n)
    neb = np.fromiter((g.n_bg_edges for g in graphs), np.int64, n)
    nec = np.fromiter((g.n_fc_edges for g in graphs), np.int64, n)
    if spec.align:
        # tile-aligned packing: no molecule straddles a tn-node tile on any
        # node axis (atoms / bond-nodes / frags / fconn-nodes); the gaps are
        # ordinary masked pad slots mid-array
        a_off = _aligned_starts(na, spec.tn_of("atom"))
        e_off = _aligned_starts(ne, spec.tn_of("bond"))
        f_off = _aligned_starts(nf, spec.tn_of("frag"))
        c_off = _aligned_starts(nc, spec.tn_of("fc"))
    else:
        a_off = np.concatenate([[0], np.cumsum(na)])
        e_off = np.concatenate([[0], np.cumsum(ne)])
        f_off = np.concatenate([[0], np.cumsum(nf)])
        c_off = np.concatenate([[0], np.cumsum(nc)])
    Ta, Te, Tf = int(a_off[-1]), int(e_off[-1]), int(f_off[-1])
    Tc, Teb, Tec = int(c_off[-1]), int(neb.sum()), int(nec.sum())

    def _ranges(starts, counts):
        """Destination indices: contiguous slice when packing has no gaps,
        else the concatenation of each molecule's [start, start+count)."""
        tot = int(counts.sum())
        if int(starts[-1]) == tot:
            return slice(0, tot)
        rep = np.repeat(starts[:-1], counts)
        base = np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])),
                         counts)
        return rep + np.arange(tot) - base

    dest_a = _ranges(a_off, na)
    dest_e = _ranges(e_off, ne)
    dest_f = _ranges(f_off, nf)
    dest_c = _ranges(c_off, nc)

    def cat(field, axis=0):
        return np.concatenate([getattr(g, field) for g in graphs] or [
            np.take(getattr(ref, field), [], axis=axis)], axis=axis)

    x_atoms[dest_a] = cat("x_atoms")
    ei = cat("edge_index", axis=1)
    rep_ae = np.repeat(a_off[:-1], ne)  # per-edge atom offset
    edge_src[dest_e] = ei[0] + rep_ae
    edge_dst[dest_e] = ei[1] + rep_ae
    edge_attr[dest_e] = cat("edge_attr")
    atom_mask[dest_a] = 1.0
    edge_mask[dest_e] = 1.0

    nf_bonds[dest_e] = cat("nf_bonds")
    # reference unpacks `target, source = edge_index_bonds_graph`
    # (gat2.py:138): row 0 is the aggregation target → our *_dst.
    eib = cat("ei_bonds", axis=1)
    rep_eb = np.repeat(e_off[:-1], neb)
    bg_dst[:Teb] = eib[0] + rep_eb
    bg_src[:Teb] = eib[1] + rep_eb
    ea_bonds[:Teb] = cat("ea_bonds")
    bg_mask[:Teb] = 1.0

    x_frags[dest_f] = cat("x_frags")
    # `source, target = frag_index` (gat2.py:283): row 0 is the source.
    fi = cat("frag_index", axis=1)
    rep_fc = np.repeat(f_off[:-1], nc)
    frag_src[dest_c] = fi[0] + rep_fc
    frag_dst[dest_c] = fi[1] + rep_fc
    cnx_attr[dest_c] = cat("cnx_attr")
    frag_mask[dest_f] = 1.0
    fconn_mask[dest_c] = 1.0

    nf_fbonds[dest_c] = cat("nf_fbonds")
    # `target, source = edge_index_fbond_graph` (gat2.py:239).
    eif = cat("ei_fbonds", axis=1)
    rep_cf = np.repeat(c_off[:-1], nec)
    fc_dst[:Tec] = eif[0] + rep_cf
    fc_src[:Tec] = eif[1] + rep_cf
    ea_fbonds[:Tec] = cat("ea_fbonds")
    fc_mask[:Tec] = 1.0

    atom_to_frag[dest_a] = cat("atom_to_frag") + np.repeat(f_off[:-1], na)
    atom_batch[dest_a] = np.repeat(np.arange(n, dtype=np.int32), na)
    frag_batch[dest_f] = np.repeat(np.arange(n, dtype=np.int32), nf)

    for gi, g in enumerate(graphs):
        yv = g.y.reshape(-1)
        y[gi, : yv.shape[0]] = yv
    graph_mask[:n] = 1.0

    if with_targets and graphs and all(g.bnd_lngth is not None
                                       for g in graphs):
        bnd_lngth[dest_e] = cat("bnd_lngth")
        dh_angl[dest_e] = cat("dh_angl")
        bnd_angl[dest_a] = cat("bnd_angl")
    elif with_targets:
        for gi, g in enumerate(graphs):  # mixed availability (rare)
            if g.bnd_lngth is not None:
                e0, a0 = int(e_off[gi]), int(a_off[gi])
                bnd_lngth[e0:e0 + int(ne[gi])] = g.bnd_lngth
                dh_angl[e0:e0 + int(ne[gi])] = g.dh_angl
                bnd_angl[a0:a0 + int(na[gi])] = g.bnd_angl
    if protein is not None and n:
        protein[:n] = np.stack([g.protein for g in graphs])
    if gene_expr is not None and n:
        gene_expr[:n] = np.stack([g.gene_expr for g in graphs])

    tcsr_kw = {}
    if spec.tcsr:
        from fragnet_tpu_torch.ops.tcsr import build_tile_meta

        tcsr_kw["tm_atom"] = build_tile_meta(
            edge_src, edge_dst, edge_mask, A, tn=spec.tn_of("atom"),
            te=spec.te, n_chunks=spec.tc_atom[0], k_src=spec.tc_atom[1])
        tcsr_kw["tm_bond"] = build_tile_meta(
            bg_src, bg_dst, bg_mask, E, tn=spec.tn_of("bond"), te=spec.te,
            n_chunks=spec.tc_bond[0], k_src=spec.tc_bond[1])
        tcsr_kw["tm_frag"] = build_tile_meta(
            frag_src, frag_dst, fconn_mask, F, tn=spec.tn_of("frag"),
            te=spec.te, n_chunks=spec.tc_frag[0], k_src=spec.tc_frag[1])
        tcsr_kw["tm_fc"] = build_tile_meta(
            fc_src, fc_dst, fc_mask, C, tn=spec.tn_of("fc"), te=spec.te,
            n_chunks=spec.tc_fc[0], k_src=spec.tc_fc[1])
        if any(v is None for v in tcsr_kw.values()):
            if strict_tcsr:
                # the packed-transport layout hard-codes the TCSR entries;
                # a silent XLA fallback here would crash pack_batch with an
                # opaque AttributeError hours into a stream (ADVICE r4) —
                # name the level and the pinned windows instead
                bad = [k for k, v in tcsr_kw.items() if v is None]
                pins = {"tm_atom": spec.tc_atom, "tm_bond": spec.tc_bond,
                        "tm_frag": spec.tc_frag, "tm_fc": spec.tc_fc}
                raise ValueError(
                    f"batch exceeds the pinned TCSR windows at level(s) "
                    f"{bad} (pinned (n_chunks, k_src) = "
                    f"{ {k: pins[k] for k in bad} }); the packed stream "
                    f"requires every batch to fit the pins — enlarge the "
                    f"spec slack (hiergraph._pin_tcsr) or rebuild the spec "
                    f"from this dataset")
            tcsr_kw = {}  # batch exceeds pinned windows — segment-path fallback

    dense_kw = {}
    if spec.align and spec.tcsr and build_dense:
        from fragnet_tpu_torch.ops.dense_gat import build_dense_planes

        # zero-gather dense planes for the rank-structured levels; None when
        # a molecule exceeds tn nodes at that level (the layer then falls
        # back to the TCSR kernel for it)
        dense_kw["dp_bond"] = build_dense_planes(
            bg_src, bg_dst, bg_mask, ea_bonds, E, tn=spec.tn_of("bond"))
        dense_kw["dp_fc"] = build_dense_planes(
            fc_src, fc_dst, fc_mask, ea_fbonds, C, tn=spec.tn_of("fc"))
        # adjacency-only planes for the dynamic-attr dense passes
        dense_kw["dp_atom"] = build_dense_planes(
            edge_src, edge_dst, edge_mask, np.zeros((E, 0), np.float32),
            A, tn=spec.tn_of("atom"))
        dense_kw["dp_frag"] = build_dense_planes(
            frag_src, frag_dst, fconn_mask, np.zeros((C, 0), np.float32),
            F, tn=spec.tn_of("frag"))

    ell_kw = {}
    if spec.k_atom is not None:
        from fragnet_tpu_torch.ops.ell import build_ell_table

        # atom tables index the EXTENDED edge array: real edge ids [0, E),
        # then self-loop id E + i for atom slot i (matching the model's
        # concatenation order, gat2.py:179-185)
        ext_dst = np.concatenate([edge_dst, np.arange(A, dtype=np.int32)])
        ext_mask = np.concatenate([edge_mask, np.ones((A,), np.float32)])
        ell_kw["atom_nbr_edge"], ell_kw["atom_nbr_mask"] = build_ell_table(
            ext_dst, A, spec.k_atom, edge_mask=ext_mask
        )
        ell_kw["bg_nbr_edge"], ell_kw["bg_nbr_mask"] = build_ell_table(
            bg_dst, E, spec.k_bg, edge_mask=bg_mask
        )
        ell_kw["frag_nbr_edge"], ell_kw["frag_nbr_mask"] = build_ell_table(
            frag_dst, F, spec.k_frag, edge_mask=fconn_mask
        )
        ell_kw["fc_nbr_edge"], ell_kw["fc_nbr_mask"] = build_ell_table(
            fc_dst, C, spec.k_fc, edge_mask=fc_mask
        )

    return HierGraphBatch(
        x_atoms=x_atoms, edge_src=edge_src, edge_dst=edge_dst,
        edge_attr=edge_attr, atom_mask=atom_mask, edge_mask=edge_mask,
        nf_bonds=nf_bonds, bg_src=bg_src, bg_dst=bg_dst, ea_bonds=ea_bonds,
        bg_mask=bg_mask, x_frags=x_frags, frag_src=frag_src,
        frag_dst=frag_dst, cnx_attr=cnx_attr, frag_mask=frag_mask,
        fconn_mask=fconn_mask, nf_fbonds=nf_fbonds, fc_src=fc_src,
        fc_dst=fc_dst, ea_fbonds=ea_fbonds, fc_mask=fc_mask,
        atom_to_frag=atom_to_frag, atom_batch=atom_batch,
        frag_batch=frag_batch, y=y, graph_mask=graph_mask,
        bnd_lngth=bnd_lngth, bnd_angl=bnd_angl, dh_angl=dh_angl,
        protein=protein, gene_expr=gene_expr, **ell_kw, **tcsr_kw,
        **dense_kw,
    )
