"""Single-buffer batch transport (counterpart of fragnet_tpu/data/packing.py).

A padded ``HierGraphBatch`` is packed on the host into ONE contiguous uint8
buffer (~6x smaller than its f32/i32 arrays), moved to the device in one
copy (graphs/batch.py:PackedUploader) and decoded there:

  * x_atoms and the 0/1 one-hots (nf_bonds, cnx_attr, nf_fbonds) → int8;
  * edge_attr → aliased to nf_bonds (the builder copies it, build.py:270);
  * validity masks → ONE i32 count each where the mask is a contiguous
    prefix (decoded as arange < count), else int8 (always on the four node
    axes of tile-aligned batches, whose masks have gaps);
  * x_frags → recomputed as segment_sum(x_atoms, atom_to_frag), exactly its
    definition (reference data.py:421-424): the summands are small
    integers, so the f32 sum is exact in any order;
  * index arrays → uint16 when the level's capacity allows, else int32;
  * the model-dtype floats (ea_bonds, gene_expr) → bf16 when the model
    computes in bf16 (``build_layout(compute_dtype=...)``; the layers cast
    their inputs to bf16 anyway, and the plane builder widens them back to
    f32 exactly), else f32; the pretrain targets / y → f32; TCSR tile
    metadata → u16 windows and an i32 ``flat_slot``;
  * the dense planes are not transported: ``unpack_batch`` rebuilds the
    levels listed in ``layout.dp_specs`` that the kernel policy reads
    (``plane_levels``: ``dp_bond`` and ``dp_fc`` under the default policy,
    and the adjacency-only ``dp_atom`` / ``dp_frag`` at R = 0 under
    ``attr=True``) with the device plane builder
    (ops/dense_gat.py:build_dense_planes_device); a level the policy does
    not read stays None.

``build_layout(compact=True)`` (``BatchLoader(pack_compact=True)``) adds
the JAX package's compact encodings, ~3x fewer bytes than the default
profile's, each chosen only where the template batch satisfies its
assumption and re-checked when a batch is packed:

  * x_atoms → sparse rows, (column u8, value i8) × k per row, decoded with
    one scatter-add (the values are small integers: exact);
  * the 0/1 one-hots → little-endian bit-packed rows;
  * bg_dst → u8 in-degree run lengths (the builder emits the bond line
    graph dst-sorted), decoded without reading the count back: each row's
    run is the number of run ends at or before it (``searchsorted``);
  * bg_src → u8 offsets from each molecule's first directed bond, that
    base recomputed on the device from edge_src / atom_batch (a
    scatter-min with a large initial value);
  * TCSR ``flat_slot`` → not shipped, derived from ew_blk, dst and the
    edge ids (its definition, ops/tcsr.py).

Differences from the JAX package, none of which changes a decoded value:
every entry starts at a multiple of 16 bytes (and the buffer's length is
one), so each entry decodes as a ``view`` of the buffer in its dtype with
no copy; the buffers are therefore not byte-equal to the JAX package's as
a whole: the two layouts list the same entries (name, encoding, shape,
decoded dtype, ``k``) in the same order, and each entry's bytes are the
JAX package's bytes of it (a bf16 entry rounds to nearest even, as
ml_dtypes does), only its offset differs.

Host functions (``build_layout``, ``pack_batch``, ``dp_level_ok``) are numpy
only: pack workers import this module without torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from fragnet_tpu_torch.graphs.hiergraph import HierGraphBatch

# encodings
I8, U8, U16, I32, F32, BF16 = "i8", "u8", "u16", "i32", "f32", "bf16"
SPARSE8 = "sp8"      # sparse rows: (cols u8, vals i8) × k per row
MASKC = "maskc"      # contiguous-prefix 0/1 mask → one i32 count
BITS = "bits"        # 0/1 matrix → little-endian bitpacked rows
RUNS8 = "runs8"      # sorted index array → u8 run lengths per segment
LOC8 = "loc8"        # index array → u8 offsets from a derived per-mol base
_ITEM = {I8: 1, U8: 1, U16: 2, I32: 4, F32: 4, BF16: 2}
ALIGN = 16           # every entry's offset, and the buffer's length


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str          # HierGraphBatch field, or "tm_<lvl>.<part>"
    enc: str
    offset: int
    shape: Tuple[int, ...]
    out_dtype: str     # dtype of the decoded array
    k: int = 0         # SPARSE8: max nonzeros/row; RUNS8: run-count rows


@dataclasses.dataclass(frozen=True)
class PackLayout:
    entries: Tuple[Entry, ...]
    total_bytes: int
    aliases: Tuple[Tuple[str, str], ...]   # (field, source-field) exact copies
    recompute_x_frags: Tuple[int, int]     # (n_frags, feat_dim)
    tm_static: Tuple[Tuple[str, Tuple[int, int, int, int]], ...]  # lvl → (tn,te,nc,k)
    # dense planes rebuilt on the device in unpack_batch:
    # (dp_field, src_f, dst_f, mask_f, ea_f|"", n_nodes, tn) — only levels
    # the loader proved tile-local + collision-free dataset-wide
    dp_specs: Tuple[Tuple[str, str, str, str, str, int, int], ...] = ()

    def entry(self, name: str) -> Entry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(name)


_MASK_FIELDS = ("atom_mask", "edge_mask", "bg_mask", "frag_mask",
                "fconn_mask", "fc_mask", "graph_mask")
_BITS_FIELDS = ("nf_bonds", "cnx_attr", "nf_fbonds")
_I8_FIELDS = ("ea_fbonds", "protein")
_IDX_FIELDS = {
    # field → capacity source (max exclusive value an index may take)
    "edge_src": "n_atoms", "edge_dst": "n_atoms",
    "frag_src": "n_frags", "frag_dst": "n_frags",
    "fc_src": "n_fconn", "fc_dst": "n_fconn",
    "atom_to_frag": "n_frags", "atom_batch": "n_graphs",
    "frag_batch": "n_graphs",
}
_F_FIELDS = ("ea_bonds", "gene_expr")          # model-dtype floats
_F32_FIELDS = ("y", "bnd_lngth", "bnd_angl", "dh_angl")
_TM_LEVELS = ("tm_atom", "tm_bond", "tm_frag", "tm_fc")
_TM_DST = {"tm_atom": "edge_dst", "tm_bond": "bg_dst",
           "tm_frag": "frag_dst", "tm_fc": "fc_dst"}
_TM_MASK = {"tm_atom": "edge_mask", "tm_bond": "bg_mask",
            "tm_frag": "fconn_mask", "tm_fc": "fc_mask"}


def _caps(b: HierGraphBatch) -> dict:
    return {
        "n_atoms": b.x_atoms.shape[0], "n_edges": b.edge_src.shape[0],
        "n_frags": b.x_frags.shape[0], "n_fconn": b.nf_fbonds.shape[0],
        "n_graphs": b.y.shape[0],
    }


def _is_prefix_mask(mask: np.ndarray) -> bool:
    c = int(mask.sum())
    return bool(mask[:c].all()) and not mask[c:].any()


def _bg_runs_ok(b: HierGraphBatch) -> bool:
    """bg_dst must be sorted over the real prefix with in-degrees ≤ 255."""
    c = int(np.asarray(b.bg_mask).sum())
    d = np.asarray(b.bg_dst)[:c]
    if c and (np.diff(d) < 0).any():
        return False
    indeg = np.bincount(d, minlength=b.edge_src.shape[0])
    return indeg.max(initial=0) <= 255


def _bond_base(edge_src: np.ndarray, atom_batch: np.ndarray,
               n_graphs: int) -> np.ndarray:
    """First directed-bond id of each molecule (host mirror of the device
    derivation)."""
    mol = atom_batch[edge_src]
    base = np.full((n_graphs,), len(edge_src), np.int64)
    np.minimum.at(base, mol, np.arange(len(edge_src)))
    return base


def _bg_loc8_ok(b: HierGraphBatch) -> bool:
    caps = _caps(b)
    base = _bond_base(np.asarray(b.edge_src), np.asarray(b.atom_batch),
                      caps["n_graphs"])
    mask = np.asarray(b.bg_mask) > 0
    src = np.asarray(b.bg_src)
    dst = np.asarray(b.bg_dst)
    mol = np.asarray(b.atom_batch)[np.asarray(b.edge_src)[dst]]
    loc = src - base[mol]
    return bool((loc[mask] >= 0).all() and (loc[mask] <= 255).all())


_ALIGNED_NODE_MASKS = ("atom_mask", "edge_mask", "frag_mask", "fconn_mask")


_DP_LEVELS = {
    # dp field → (src, dst, mask, ea or "", n_nodes key)
    "dp_bond": ("bg_src", "bg_dst", "bg_mask", "ea_bonds", "n_edges"),
    "dp_fc": ("fc_src", "fc_dst", "fc_mask", "ea_fbonds", "n_fconn"),
    "dp_atom": ("edge_src", "edge_dst", "edge_mask", "", "n_atoms"),
    "dp_frag": ("frag_src", "frag_dst", "fconn_mask", "", "n_frags"),
}
_DP_TM = {"dp_bond": "tm_bond", "dp_fc": "tm_fc",
          "dp_atom": "tm_atom", "dp_frag": "tm_frag"}


def dp_level_ok(graphs, level: str, tn: int) -> bool:
    """Can ``level``'s dense planes be rebuilt on device for EVERY batch of
    these graphs? Requires (a) no molecule exceeding tn nodes at the level
    (tile-aligned packing then keeps every edge tile-local) and (b) no
    molecule with duplicate (dst, src) pairs (a dense slot would collide —
    molecules never collide with each other: distinct local id ranges).
    Mirrors ops/dense_gat.build_dense_planes's per-batch None conditions,
    decided once per dataset."""
    count_attr = {"dp_bond": "n_edges", "dp_fc": "n_fconn",
                  "dp_atom": "n_atoms", "dp_frag": "n_frags"}[level]
    idx_attr = {"dp_bond": "ei_bonds", "dp_fc": "ei_fbonds",
                "dp_atom": "edge_index", "dp_frag": "frag_index"}[level]
    for g in graphs:
        if getattr(g, count_attr) > tn:
            return False
        ei = np.asarray(getattr(g, idx_attr))
        if ei.size:
            key = ei[0].astype(np.int64) * (1 << 20) + ei[1]
            if len(np.unique(key)) != key.shape[0]:
                return False
    return True


def plane_levels(policy) -> Tuple[str, ...]:
    """The dense-plane levels a ``KernelPolicy`` reads, in ``_DP_LEVELS``
    order: ``dp_bond`` under ``bond="planes"``, ``dp_fc`` under ``fc`` in
    {"planes", "attr"} (the dense-attr pass reads its adjacency rows),
    ``dp_atom`` and ``dp_frag`` under ``attr=True``."""
    read = {"dp_bond": policy.bond == "planes",
            "dp_fc": policy.fc in ("planes", "attr"),
            "dp_atom": bool(policy.attr), "dp_frag": bool(policy.attr)}
    return tuple(lvl for lvl in _DP_LEVELS if read[lvl])


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _is_bf16(dtype) -> bool:
    """Whether ``dtype`` (a torch or JAX dtype, or its name) is bfloat16 —
    read from its name, so that pack workers need neither package."""
    name = str(dtype).lower()
    return "bfloat16" in name or name == "bf16"


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values → their bf16 bit patterns (uint16), rounded to nearest
    even as ml_dtypes and torch round; a NaN stays a (quiet) NaN."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    r = np.where(nan, (u >> 16) | np.uint32(0x40), r)
    return r.astype(np.uint16)


def _refuse_ell(batch) -> None:
    if batch.atom_nbr_edge is not None:
        raise ValueError("packed transport does not support the ELL path")


def build_layout(template: HierGraphBatch, compute_dtype="float32",
                 sparse_k: Optional[int] = None, compact: bool = False,
                 aligned: bool = False,
                 dp_levels: Tuple[str, ...] = ()) -> PackLayout:
    """Derive the static layout from one template batch (shapes come from the
    PadSpec so every batch of the spec conforms; value-level assumptions are
    re-checked on every pack, and relaxed here when the template already
    violates them). Signature and entry order as the JAX package's:
    ``compute_dtype`` (bf16, by a torch or JAX dtype or its name, or f32)
    sets the model-dtype floats' encoding. ``compact=False`` (the "fast"
    profile): every encoding is a copy on the host and a view or cast on the
    device. ``compact=True`` adds the sparse / bit / run-length /
    molecule-local encodings (see the module docstring), ``sparse_k`` the
    sparse rows' width (default: the template's widest row + 2). A batch
    with ELL tables raises, as in the JAX package."""
    _refuse_ell(template)
    if compact and template.x_atoms.shape[1] > 256:
        raise ValueError("sparse x_atoms encoding needs feat dim <= 256")
    caps = _caps(template)
    entries = []
    off = 0

    def add(name, enc, shape, out_dtype, k=0):
        nonlocal off
        if enc == SPARSE8:
            nbytes = 2 * shape[0] * k
        elif enc == MASKC:
            nbytes = 4
        elif enc == BITS:
            nbytes = shape[0] * ((shape[1] + 7) // 8)
        elif enc == RUNS8:
            nbytes = k
        elif enc == LOC8:
            nbytes = shape[0]
        else:
            nbytes = int(np.prod(shape)) * _ITEM[enc]
        entries.append(Entry(name, enc, off, tuple(int(s) for s in shape),
                             out_dtype, k))
        off = _align(off + nbytes)

    if compact:
        x = np.asarray(template.x_atoms)
        k = sparse_k or int((x != 0).sum(1).max()) + 2
        add("x_atoms", SPARSE8, x.shape, "float32", k=k)
    else:
        add("x_atoms", I8, template.x_atoms.shape, "float32")
    for f in _MASK_FIELDS:
        arr = np.asarray(getattr(template, f))
        # tile-ALIGNED packing puts gaps mid-array on the four node axes, so
        # a template whose mask happens to be a contiguous prefix must NOT
        # lock in the one-count encoding (a later batch with a gap would
        # decode as a wrong prefix mask)
        maskc_ok = _is_prefix_mask(arr) and not (
            aligned and f in _ALIGNED_NODE_MASKS)
        add(f, MASKC if maskc_ok else I8, arr.shape, "float32")
    for f in _BITS_FIELDS:
        arr = np.asarray(getattr(template, f))
        ok = compact and np.isin(arr, (0.0, 1.0)).all()
        add(f, BITS if ok else I8, arr.shape, "float32")
    for f in _I8_FIELDS:
        arr = getattr(template, f)
        if arr is not None:
            add(f, I8, np.asarray(arr).shape,
                "int32" if f == "protein" else "float32")

    # bond line graph: run-length dst + molecule-local src when valid
    E = caps["n_edges"]
    idx = U16 if E <= 65535 else I32
    shape = np.asarray(template.bg_dst).shape
    if compact and _bg_runs_ok(template):
        add("bg_dst", RUNS8, shape, "int32", k=E)
    else:
        add("bg_dst", idx, shape, "int32")
    if compact and _bg_loc8_ok(template):
        add("bg_src", LOC8, np.asarray(template.bg_src).shape, "int32")
    else:
        add("bg_src", idx, np.asarray(template.bg_src).shape, "int32")
    for f, cap in _IDX_FIELDS.items():
        enc = U16 if caps[cap] <= 65535 else I32
        add(f, enc, np.asarray(getattr(template, f)).shape, "int32")
    fdt = "bfloat16" if _is_bf16(compute_dtype) else "float32"
    for f in _F_FIELDS:
        arr = getattr(template, f)
        if arr is not None:
            add(f, BF16 if fdt == "bfloat16" else F32, np.asarray(arr).shape,
                fdt)
    for f in _F32_FIELDS:
        arr = getattr(template, f)
        if arr is not None:
            add(f, F32, np.asarray(arr).shape, "float32")

    tm_static = []
    for lvl in _TM_LEVELS:
        tm = getattr(template, lvl)
        if tm is None:
            continue
        tm_static.append((lvl, (tm.tn, tm.te, tm.n_chunks, tm.k_src)))
        n_tiles = len(np.asarray(tm.ew_blk))
        add(f"{lvl}.ew_blk", U16, (n_tiles,), "int32")
        add(f"{lvl}.sw_tile", U16, (n_tiles,), "int32")
        add(f"{lvl}.cw", U16, (n_tiles,), "int32")
        if not compact:  # compact derives flat_slot from ew_blk + dst + ids
            add(f"{lvl}.flat_slot", I32, np.asarray(tm.flat_slot).shape,
                "int32")

    aliases = []
    if np.array_equal(np.asarray(template.edge_attr),
                      np.asarray(template.nf_bonds)):
        aliases.append(("edge_attr", "nf_bonds"))
    else:  # defensive; the builder copies nf_bonds from edge_attr
        add("edge_attr", I8, template.edge_attr.shape, "float32")

    dp_specs = []
    if dp_levels and tm_static:
        # per-axis node tiles (PadSpec.tn_of): each dense-plane level uses
        # its OWN tm level's tile size (dp_bond ↔ tm_bond, ...)
        tn_of = {lvl: st[0] for lvl, st in tm_static}
        for lvl in dp_levels:
            src_f, dst_f, mask_f, ea_f, nkey = _DP_LEVELS[lvl]
            tn = tn_of.get("tm_" + lvl[3:], tm_static[0][1][0])
            if caps[nkey] % tn == 0:
                dp_specs.append((lvl, src_f, dst_f, mask_f, ea_f,
                                 caps[nkey], tn))

    return PackLayout(
        entries=tuple(entries), total_bytes=off, aliases=tuple(aliases),
        recompute_x_frags=(int(template.x_frags.shape[0]),
                           int(template.x_frags.shape[1])),
        tm_static=tuple(tm_static),
        dp_specs=tuple(dp_specs),
    )


# ---------------------------------------------------------------------------
# host-side pack
# ---------------------------------------------------------------------------

def _sparse_rows(x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(A, D) → (cols (A,k) u8, vals (A,k) i8); unused slots are (0, 0)."""
    A = x.shape[0]
    r, c = np.nonzero(x)
    counts = np.bincount(r, minlength=A)
    if counts.max(initial=0) > k:
        raise ValueError(f"x_atoms row has {counts.max()} nonzeros > k={k}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(r)) - np.repeat(starts, counts)
    cols = np.zeros((A, k), np.uint8)
    vals = np.zeros((A, k), np.int8)
    v = x[r, c]
    vi = v.astype(np.int8)
    if not np.array_equal(vi.astype(x.dtype), v):
        raise ValueError("x_atoms values are not int8-exact")
    cols[r, pos] = c
    vals[r, pos] = vi
    return cols, vals


def _check_int8(name: str, arr: np.ndarray) -> np.ndarray:
    b = arr.astype(np.int8)
    if not np.array_equal(b.astype(arr.dtype), arr):
        raise ValueError(f"field {name} is not int8-exact")
    return b


def pack_batch(batch: HierGraphBatch, layout: PackLayout,
               validate: bool = False) -> np.ndarray:
    """``validate=True`` runs full value-level checks (every lossy-if-wrong
    encoding is verified exactly). The loaders validate the FIRST batch of a
    spec; later batches come from the same builder invariants, so they skip
    the O(bytes) checks (the cheap range checks always run). A batch with
    ELL tables raises, as ``build_layout`` does."""
    _refuse_ell(batch)
    buf = np.zeros((layout.total_bytes,), np.uint8)
    caps = _caps(batch)

    def put(e: Entry, raw: np.ndarray):
        bts = raw.tobytes()
        buf[e.offset : e.offset + len(bts)] = np.frombuffer(bts, np.uint8)

    for e in layout.entries:
        if "." in e.name:
            lvl, part = e.name.split(".")
            tm = getattr(batch, lvl)
            if tm is None:
                raise ValueError(
                    f"batch has no {lvl} TileMeta but the pack layout "
                    f"requires it — the batch exceeded the pinned TCSR "
                    f"windows. Build packed batches with strict_tcsr=True "
                    f"to get the precise level/pin diagnosis "
                    f"(graphs/hiergraph.pad_batch)")
            arr = np.asarray(getattr(tm, part))
        else:
            arr = np.asarray(getattr(batch, e.name))
        if e.enc == SPARSE8:
            cols, vals = _sparse_rows(arr, e.k)
            put(e, np.concatenate([cols.reshape(-1),
                                   vals.reshape(-1).view(np.uint8)]))
        elif e.enc == MASKC:
            # always checked: a non-prefix mask encoded as a count silently
            # corrupts training; the check is O(n)
            if not _is_prefix_mask(arr):
                raise ValueError(
                    f"mask {e.name} is not a contiguous prefix but the "
                    f"layout chose the count encoding from the template "
                    f"batch; rebuild the layout with aligned=True (or "
                    f"report this as a batcher invariant violation)")
            put(e, np.asarray([int(arr.sum())], np.int32))
        elif e.enc == BITS:
            b = arr.astype(np.uint8)
            if validate and (
                    not np.array_equal(b.astype(arr.dtype), arr)
                    or b.max(initial=0) > 1):
                raise ValueError(f"field {e.name} is not 0/1")
            put(e, np.packbits(b, axis=1, bitorder="little"))
        elif e.enc == RUNS8:
            c = int(np.asarray(batch.bg_mask).sum())
            indeg = np.bincount(arr[:c], minlength=e.k)
            if indeg.max(initial=0) > 255 or (validate and not np.array_equal(
                    np.repeat(np.arange(e.k), indeg), arr[:c])):
                raise ValueError("bg_dst is not run-length-encodable")
            put(e, indeg.astype(np.uint8))
        elif e.enc == LOC8:
            base = _bond_base(np.asarray(batch.edge_src),
                              np.asarray(batch.atom_batch), caps["n_graphs"])
            mol = np.asarray(batch.atom_batch)[
                np.asarray(batch.edge_src)[np.asarray(batch.bg_dst)]]
            loc = arr.astype(np.int64) - base[mol]
            loc = np.where(np.asarray(batch.bg_mask) > 0, loc, 0)
            if loc.min(initial=0) < 0 or loc.max(initial=0) > 255:
                raise ValueError("bg_src not molecule-local-u8 encodable")
            put(e, loc.astype(np.uint8))
        elif e.enc == I8:
            put(e, _check_int8(e.name, arr) if validate
                else arr.astype(np.int8))
        elif e.enc == U8:
            put(e, arr.astype(np.uint8))
        elif e.enc == U16:
            if validate and (arr.min(initial=0) < 0
                             or arr.max(initial=0) > 65535):
                raise ValueError(f"field {e.name} out of uint16 range")
            put(e, arr.astype(np.uint16))
        elif e.enc == I32:
            put(e, arr if arr.dtype == np.int32 else arr.astype(np.int32))
        elif e.enc == BF16:
            put(e, to_bf16_bits(arr))
        else:
            put(e, arr if arr.dtype == np.float32 else arr.astype(np.float32))
    return buf


# ---------------------------------------------------------------------------
# device-side unpack
# ---------------------------------------------------------------------------

def _decode(buf, e: Entry):
    """One entry of the uint8 tensor ``buf`` as a tensor of its decoded
    dtype: a view of the buffer where the encoded dtype is the decoded one
    (i32, f32, bf16), else one cast. SPARSE8, RUNS8 and LOC8 entries decode
    in ``unpack_batch``."""
    import torch

    n = int(np.prod(e.shape))
    odt = getattr(torch, e.out_dtype)
    if e.enc == MASKC:
        cnt = buf[e.offset : e.offset + 4].view(torch.int32)
        return (torch.arange(e.shape[0], device=buf.device) < cnt).to(odt)
    if e.enc == BITS:
        R, D = e.shape
        nb = (D + 7) // 8
        raw = buf[e.offset : e.offset + R * nb].reshape(R, nb)
        shifts = torch.arange(8, dtype=torch.uint8, device=buf.device)
        bits = (raw[:, :, None] >> shifts) & 1
        return bits.reshape(R, nb * 8)[:, :D].to(odt)
    tdt = {I8: torch.int8, U8: torch.uint8, U16: torch.uint16,
           I32: torch.int32, F32: torch.float32, BF16: torch.bfloat16}[e.enc]
    raw = buf[e.offset : e.offset + n * _ITEM[e.enc]].view(tdt)
    return raw.reshape(e.shape).to(odt)


def _decode_sparse(buf, e: Entry):
    """SPARSE8 rows → the dense (A, D) f32 matrix: one scatter-add of the
    int8 values into their u8 columns (unused slots add 0 to column 0; the
    values are small integers, so the sum is exact in any order)."""
    import torch

    A, D = e.shape
    k = e.k
    cols = buf[e.offset : e.offset + A * k].reshape(A, k).long()
    vals = buf[e.offset + A * k : e.offset + 2 * A * k].view(
        torch.int8).reshape(A, k).float()
    x = torch.zeros((A, D), dtype=torch.float32, device=buf.device)
    return x.scatter_add_(1, cols, vals)


def _decode_runs8(buf, e: Entry, bg_mask):
    """bg_dst from its u8 in-degrees, without a read-back of their sum: row
    i belongs to the run whose end is the first one past i (the number of
    run ends at or before i), padding rows masked to 0 as in the JAX
    package (whose ``jnp.repeat`` pads with the last value)."""
    import torch

    indeg = buf[e.offset : e.offset + e.k].long()
    ends = torch.cumsum(indeg, 0)
    rows = torch.arange(e.shape[0], device=buf.device)
    rep = torch.searchsorted(ends, rows, right=True)
    return torch.where(bg_mask > 0, rep, 0).to(torch.int32)


def _decode_loc8(buf, e: Entry, fields):
    """bg_src from its u8 molecule-local offsets: each molecule's first
    directed bond is a scatter-min over the bonds' molecules (a large
    initial value where a molecule has none, never read back), and a row's
    source is its destination molecule's base plus its offset."""
    import torch

    loc = buf[e.offset : e.offset + e.shape[0]].long()
    edge_src = fields["edge_src"].long()
    E = edge_src.shape[0]
    G = fields["y"].shape[0]
    mol_of_bond = fields["atom_batch"].long()[edge_src]
    base = torch.full((G,), E, dtype=torch.long, device=buf.device)
    base = base.scatter_reduce(0, mol_of_bond,
                               torch.arange(E, device=buf.device), "amin")
    src = base[mol_of_bond[fields["bg_dst"].long()]] + loc
    return torch.where(fields["bg_mask"] > 0, src, 0).to(torch.int32)


def _derive_flat_slot(fields, lvl: str, parts, tn: int, te: int, nc: int):
    """A level's TCSR ``flat_slot`` (its definition, ops/tcsr.py): each kept
    edge's slot in its destination tile's window, 0 for a masked edge."""
    import torch

    dst = fields[_TM_DST[lvl]].long()
    tile = dst // tn
    eids = torch.arange(dst.shape[0], device=dst.device)
    flat = tile * (nc * te) + (eids - parts["ew_blk"].long()[tile] * te)
    return torch.where(fields[_TM_MASK[lvl]] > 0, flat, 0).to(torch.int32)


def unpack_batch(buf, layout: PackLayout,
                 planes: Sequence[str] = ("dp_bond", "dp_fc")
                 ) -> HierGraphBatch:
    """Decode a packed uint8 tensor into a ``HierGraphBatch`` of tensors on
    the buffer's device (the torch counterpart of the JAX unpack_batch,
    packing.py:504-588), with no read-back to the host in either profile.
    Each field comes back in its entry's decoded dtype: a bf16 layout's
    ea_bonds and gene_expr in bf16, as the JAX package's do. Dense planes
    are rebuilt for the ``layout.dp_specs`` levels named in ``planes`` —
    pass ``plane_levels(policy)``, the levels the model's kernel policy
    reads — with the device plane builder (on CUDA the K6 kernel, on the
    CPU its plain version), from the widened attributes."""
    from fragnet_tpu_torch import obs

    with obs.span("fragnet.data.decode"):
        return add_planes(_decode_fields(buf, layout), layout, planes)


def _decode_fields(buf, layout: PackLayout) -> HierGraphBatch:
    """``unpack_batch``'s fields, without the dense planes."""
    import torch

    from fragnet_tpu_torch.ops.tcsr import TileMeta

    if buf.dtype != torch.uint8 or tuple(buf.shape) != (layout.total_bytes,):
        raise ValueError(f"packed buffer has dtype {buf.dtype} and shape "
                         f"{tuple(buf.shape)}, expected uint8 "
                         f"({layout.total_bytes},)")
    fields: dict = {f.name: None for f in dataclasses.fields(HierGraphBatch)}
    tm_parts: dict = {}
    deferred = []
    for e in layout.entries:
        if "." in e.name:
            lvl, part = e.name.split(".")
            tm_parts.setdefault(lvl, {})[part] = _decode(buf, e)
        elif e.enc == SPARSE8:
            fields[e.name] = _decode_sparse(buf, e)
        elif e.enc in (RUNS8, LOC8):
            deferred.append(e)  # need masks / other index fields first
        else:
            fields[e.name] = _decode(buf, e)
    # LOC8 bg_src reads bg_dst, so RUNS8 decodes first
    for e in sorted(deferred, key=lambda e: e.enc != RUNS8):
        if e.enc == RUNS8:
            fields["bg_dst"] = _decode_runs8(buf, e, fields["bg_mask"])
        else:
            fields["bg_src"] = _decode_loc8(buf, e, fields)

    for dst_f, src_f in layout.aliases:
        fields[dst_f] = fields[src_f]

    F, D = layout.recompute_x_frags
    x = fields["x_atoms"]
    fields["x_frags"] = torch.zeros((F, D), dtype=x.dtype, device=x.device
                                    ).index_add_(0, fields["atom_to_frag"], x)

    for lvl, (tn, te, nc, kk) in layout.tm_static:
        parts = tm_parts[lvl]
        flat = parts.get("flat_slot")
        if flat is None:
            flat = _derive_flat_slot(fields, lvl, parts, tn, te, nc)
        fields[lvl] = TileMeta(ew_blk=parts["ew_blk"], sw_tile=parts["sw_tile"],
                               flat_slot=flat, cw=parts["cw"],
                               tn=tn, te=te, n_chunks=nc, k_src=kk)

    return HierGraphBatch(**fields)


def add_planes(batch: HierGraphBatch, layout: PackLayout,
               planes: Sequence[str]) -> HierGraphBatch:
    """``batch`` (decoded from a buffer of ``layout``) with the dense planes
    of the ``layout.dp_specs`` levels named in ``planes``, built on its
    device by the plane builder."""
    from fragnet_tpu_torch import obs
    from fragnet_tpu_torch.ops.dense_gat import build_dense_planes_device

    with obs.span("fragnet.data.planes"):
        built = {}
        for lvl, src_f, dst_f, mask_f, ea_f, n_nodes, _tn in layout.dp_specs:
            tm = getattr(batch, _DP_TM[lvl])
            if lvl not in planes or tm is None:
                continue
            built[lvl] = build_dense_planes_device(
                getattr(batch, src_f), getattr(batch, dst_f),
                getattr(batch, mask_f),
                getattr(batch, ea_f) if ea_f else None, n_nodes, tm)
        return dataclasses.replace(batch, **built)
