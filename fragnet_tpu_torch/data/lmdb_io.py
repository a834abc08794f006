"""Pure-Python LMDB file access (a copy of fragnet_tpu/data/lmdb_io.py;
the two read and write the same bytes) — the host-side native-equivalent of the
``lmdb`` C extension the reference uses to read UniMol ligand databases
(fragnet/dataset/utils.py:78-104: ``lmdb.open(subdir=False, readonly=True)``
+ full cursor scan + ``pickle.loads`` per record).

``lmdb`` is not installed in this environment, so the on-disk format
(OpenLDAP liblmdb data files, magic 0xBEEFC0DE, version 1) is parsed
directly:

* ``LMDBReader`` — read-only B+tree walk of a single-file (``subdir=False``)
  database: meta-page selection by txnid, branch/leaf traversal, overflow
  (BIGDATA) pages. Enough to drain any UniMol ``train.lmdb``.
* ``write_lmdb`` — a minimal writer used for fixtures and for re-sharding:
  emits a valid single-file LMDB (meta ×2 + leaves + one branch level +
  overflow pages) that liblmdb itself can open.

Format constants follow liblmdb's mdb.c (public spec); this is an original
implementation, not a translation.
"""

from __future__ import annotations

import pickle
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1
PAGEHDRSZ = 16
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF
NODE_HDRSZ = 8

# MDB_db: md_pad u32, md_flags u16, md_depth u16, branch/leaf/overflow pgno
# u64 ×3, md_entries u64, md_root u64  (48 bytes)
_DB_FMT = "<IHHQQQQQ"
# MDB_meta: magic u32, version u32, address u64, mapsize u64, dbs[2],
# last_pg u64, txnid u64
_META_HEAD_FMT = "<IIQQ"


class LMDBReader:
    """Read-only access to a single-file LMDB database (main DB only)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        meta0 = self._parse_meta(0)
        # psize lives in dbs[0].md_pad of the meta page (mdb.c mm_psize alias)
        self.psize = meta0["psize"] or 4096
        meta1 = self._parse_meta(1)
        self._meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self.main_root = self._meta["main_root"]
        self.entries = self._meta["main_entries"]

    # -- parsing ----------------------------------------------------------
    def _parse_meta(self, pageno: int) -> Dict:
        # meta page 1 sits at offset psize of meta page 0; psize is only
        # known after reading meta 0, so probe common sizes for page 1
        if pageno == 0:
            off = 0
        else:
            off = self.psize
        hdr_off = off + PAGEHDRSZ
        magic, version, _addr, _mapsize = struct.unpack_from(
            _META_HEAD_FMT, self._buf, hdr_off)
        if magic != MAGIC:
            raise ValueError(f"not an LMDB data file (magic {magic:#x})")
        if version != VERSION:
            raise ValueError(f"unsupported LMDB version {version}")
        db0 = struct.unpack_from(_DB_FMT, self._buf, hdr_off + 24)
        db1 = struct.unpack_from(_DB_FMT, self._buf, hdr_off + 24 + 48)
        last_pg, txnid = struct.unpack_from(
            "<QQ", self._buf, hdr_off + 24 + 96)
        return {
            "psize": db0[0],
            "main_root": db1[7],
            "main_entries": db1[6],
            "last_pg": last_pg,
            "txnid": txnid,
        }

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """Returns (offset, flags, lower, n_overflow_pages)."""
        off = pgno * self.psize
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        lower = struct.unpack_from("<H", self._buf, off + 12)[0]
        pages = struct.unpack_from("<I", self._buf, off + 12)[0]
        return off, flags, lower, pages

    def _node_ptrs(self, off: int, lower: int) -> List[int]:
        n = (lower - PAGEHDRSZ) // 2
        return list(struct.unpack_from(f"<{n}H", self._buf, off + PAGEHDRSZ))

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off, flags, lower, _ = self._page(pgno)
        if flags & P_LEAF2:
            raise ValueError("MDB_DUPFIXED (LEAF2) pages are not supported")
        ptrs = self._node_ptrs(off, lower)
        if flags & P_BRANCH:
            for p in ptrs:
                lo, hi, nflags, _ksize = struct.unpack_from(
                    "<HHHH", self._buf, off + p)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
        elif flags & P_LEAF:
            for p in ptrs:
                lo, hi, nflags, ksize = struct.unpack_from(
                    "<HHHH", self._buf, off + p)
                dsize = lo | (hi << 16)
                kstart = off + p + NODE_HDRSZ
                key = self._buf[kstart:kstart + ksize]
                if nflags & F_BIGDATA:
                    opgno = struct.unpack_from(
                        "<Q", self._buf, kstart + ksize)[0]
                    ooff = opgno * self.psize
                    val = self._buf[ooff + PAGEHDRSZ:
                                    ooff + PAGEHDRSZ + dsize]
                else:
                    val = self._buf[kstart + ksize:kstart + ksize + dsize]
                yield key, val
        else:
            raise ValueError(f"unexpected page flags {flags:#x} at {pgno}")

    # -- public API --------------------------------------------------------
    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.main_root == P_INVALID:
            return
        yield from self._iter_page(self.main_root)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes) -> Optional[bytes]:
        for k, v in self.items():
            if k == key:
                return v
        return None

    def __len__(self) -> int:
        return int(self.entries)


def read_unimol_lmdb(lmdb_path: str, name: Optional[str] = None) -> List[Dict]:
    """Reference ``get_data`` semantics (dataset/utils.py:78-104): scan every
    record, unpickle, keep smiles + target; multi-task names get their target
    wrapped in an extra list level."""
    reader = LMDBReader(lmdb_path)
    smiles_data = []
    for _key, raw in reader.items():
        data = pickle.loads(raw)
        smiles_data.append({"smiles": data["smi"], "target": data["target"]})
    if name in ["clintox", "tox21", "toxcast", "sider", "pcba", "muv"]:
        for rec in smiles_data:
            rec["target"] = [list(rec["target"])]
    return smiles_data


# ---------------------------------------------------------------------------
# minimal writer (fixtures / re-sharding)
# ---------------------------------------------------------------------------

def _pad_page(b: bytearray, psize: int) -> None:
    if len(b) % psize:
        b.extend(b"\x00" * (psize - len(b) % psize))


def _page_header(pgno: int, flags: int, lower: int, upper: int) -> bytes:
    return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)


def _overflow_header(pgno: int, npages: int) -> bytes:
    return struct.pack("<QHHI", pgno, 0, P_OVERFLOW, npages)


def write_lmdb(path: str, items: Dict[bytes, bytes],
               psize: int = 4096) -> None:
    """Write a single-file LMDB holding ``items`` in the main DB.

    Produces: meta pages 0/1, then leaf pages (values too large for half a
    page spill to overflow pages), then one branch root when more than one
    leaf is needed. Keys are stored in sorted (memcmp) order as liblmdb
    requires. Tree depth ≤ 2 — a branch page holds ~250 children, so this
    covers ~hundreds of thousands of small records."""
    keys = sorted(items)
    big_thresh = (psize - PAGEHDRSZ) // 2  # mdb's nodemax heuristic
    pages: List[bytes] = []  # data pages, pgno = 2 + index
    next_pgno = 2

    def add_page(raw: bytes) -> int:
        nonlocal next_pgno
        pages.append(raw)
        pgno = next_pgno
        next_pgno += len(raw) // psize
        return pgno

    # assemble leaves
    leaves: List[Tuple[bytes, List[Tuple[bytes, bytes, int, Optional[int]]]]] = []
    cur: List[Tuple[bytes, bytes, int, Optional[int]]] = []
    cur_size = 0

    def node_size(key: bytes, val: bytes, big: bool) -> int:
        sz = NODE_HDRSZ + len(key) + (8 if big else len(val))
        return sz + (sz & 1) + 2  # even-align + ptr slot

    overflow_chunks: List[Tuple[int, bytes]] = []  # (placeholder idx, value)

    def flush_leaf():
        nonlocal cur, cur_size
        if cur:
            leaves.append((cur[0][0], cur))
            cur, cur_size = [], 0

    for k in keys:
        v = items[k]
        big = len(v) > big_thresh
        sz = node_size(k, v, big)
        if cur and PAGEHDRSZ + cur_size + sz > psize:
            flush_leaf()
        cur.append((k, v, len(v), None))
        cur_size += sz
    flush_leaf()

    # materialize overflow pages first so leaves can reference them
    leaf_entries = []
    for first_key, entries in leaves:
        out = []
        for k, v, dsize, _ in entries:
            if len(v) > big_thresh:
                n_over = (len(v) + PAGEHDRSZ + psize - 1) // psize
                raw = bytearray()
                raw += _overflow_header(0, n_over)
                raw += v
                _pad_page(raw, psize)
                opgno = add_page(bytes(raw))
                # fix pgno in header
                fixed = bytearray(pages[-1])
                fixed[0:8] = struct.pack("<Q", opgno)
                pages[-1] = bytes(fixed)
                out.append((k, v, dsize, opgno))
            else:
                out.append((k, v, dsize, None))
        leaf_entries.append((first_key, out))

    # materialize leaf pages
    leaf_pgnos: List[Tuple[bytes, int]] = []
    for first_key, entries in leaf_entries:
        body = bytearray(b"\x00" * psize)
        upper = psize
        ptrs = []
        for k, v, dsize, opgno in entries:
            payload = struct.pack("<Q", opgno) if opgno is not None else v
            nsz = NODE_HDRSZ + len(k) + len(payload)
            nsz += nsz & 1
            upper -= nsz
            flags = F_BIGDATA if opgno is not None else 0
            struct.pack_into("<HHHH", body, upper,
                             dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                             flags, len(k))
            body[upper + NODE_HDRSZ:upper + NODE_HDRSZ + len(k)] = k
            body[upper + NODE_HDRSZ + len(k):
                 upper + NODE_HDRSZ + len(k) + len(payload)] = payload
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(ptrs)
        body[0:PAGEHDRSZ] = _page_header(0, P_LEAF, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
        pgno = add_page(bytes(body))
        fixed = bytearray(pages[-1])
        fixed[0:8] = struct.pack("<Q", pgno)
        pages[-1] = bytes(fixed)
        leaf_pgnos.append((first_key, pgno))

    # root
    depth = 1
    branch_pages = 0
    if not leaf_pgnos:
        root = P_INVALID
    elif len(leaf_pgnos) == 1:
        root = leaf_pgnos[0][1]
    else:
        depth = 2
        branch_pages = 1
        body = bytearray(b"\x00" * psize)
        upper = psize
        ptrs = []
        for i, (first_key, pgno) in enumerate(leaf_pgnos):
            key = b"" if i == 0 else first_key  # first branch key is empty
            nsz = NODE_HDRSZ + len(key)
            nsz += nsz & 1
            upper -= nsz
            struct.pack_into("<HHHH", body, upper,
                             pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                             (pgno >> 32) & 0xFFFF, len(key))
            body[upper + NODE_HDRSZ:upper + NODE_HDRSZ + len(key)] = key
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(ptrs)
        body[0:PAGEHDRSZ] = _page_header(0, P_BRANCH, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
        root = add_page(bytes(body))
        fixed = bytearray(pages[-1])
        fixed[0:8] = struct.pack("<Q", root)
        pages[-1] = bytes(fixed)

    last_pg = next_pgno - 1
    mapsize = max(psize * (last_pg + 1), psize * 16)

    def meta_page(pgno: int, txnid: int) -> bytes:
        body = bytearray(b"\x00" * psize)
        body[0:PAGEHDRSZ] = _page_header(pgno, P_META, 0, 0)
        off = PAGEHDRSZ
        struct.pack_into(_META_HEAD_FMT, body, off, MAGIC, VERSION, 0, mapsize)
        # FREE_DBI: empty; md_pad carries psize
        struct.pack_into(_DB_FMT, body, off + 24,
                         psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        # MAIN_DBI
        struct.pack_into(_DB_FMT, body, off + 24 + 48,
                         0, 0, depth if root != P_INVALID else 0,
                         branch_pages, len(leaf_pgnos), 0,
                         len(keys), root)
        struct.pack_into("<QQ", body, off + 24 + 96, last_pg, txnid)
        return bytes(body)

    with open(path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for p in pages:
            f.write(p)


def write_unimol_lmdb(path: str, records: Sequence[Dict]) -> None:
    """Write records shaped like the UniMol ligand DBs the reference reads:
    key = ascii index, value = pickle of {'smi': ..., 'target': ...}."""
    items = {
        str(i).encode(): pickle.dumps(
            {"smi": r["smiles"] if "smiles" in r else r["smi"],
             "target": r["target"]})
        for i, r in enumerate(records)
    }
    write_lmdb(path, items)
