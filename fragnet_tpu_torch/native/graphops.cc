// fragnet_tpu_torch native host runtime — graph construction loops
// (a copy of fragnet_tpu/native/graphops.cc).
//
// The hot index-math loops of the host pipeline, in C++ (the reference
// delegates its equivalents to torch/torch_geometric C++ ops and an O(E²)
// Python scan, fragnet/dataset/data.py:116-128):
//
//   lg_build    — directed line graph ("edges sharing exactly one atom") in
//                 O(E·deg), preserving the reference's i-major / j-ascending
//                 order incl. set-semantics for self-edges.
//   tile_meta   — per-destination-tile edge/source windows for the TCSR
//                 layout of the fused GAT kernel (ops/tcsr.py).
//
// Exposed via a plain C ABI and loaded with ctypes (native/__init__.py);
// every entry point is pure (caller allocates, no global state) so it is
// safe under Python threads releasing the GIL.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Directed line graph. Edges (src[i], dst[i]); result pairs (i, j) with
// |{src_i,dst_i} ∩ {src_j,dst_j}| == 1 under SET semantics (a self-edge
// u==v is the singleton {u}); i-major, j ascending, (i,i) kept for
// self-edges. Returns the number of pairs, or -1 if cap is too small.
int64_t lg_build(int64_t n_edges, const int32_t* src, const int32_t* dst,
                 int64_t n_nodes, int64_t cap, int32_t* out0, int32_t* out1) {
  // incidence lists in ascending edge order
  std::vector<int32_t> deg(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    ++deg[src[e]];
    if (dst[e] != src[e]) ++deg[dst[e]];
  }
  std::vector<int64_t> off(n_nodes + 1, 0);
  for (int64_t n = 0; n < n_nodes; ++n) off[n + 1] = off[n] + deg[n];
  std::vector<int32_t> inc(off[n_nodes]);
  std::vector<int64_t> fill(off.begin(), off.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    inc[fill[src[e]]++] = static_cast<int32_t>(e);
    if (dst[e] != src[e]) inc[fill[dst[e]]++] = static_cast<int32_t>(e);
  }

  int64_t n_out = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    const int32_t u = src[i], v = dst[i];
    // merge the two ascending incidence lists, deduped
    const int32_t* a = &inc[off[u]];
    const int32_t* b = &inc[off[v]];
    int64_t na = off[u + 1] - off[u];
    int64_t nb = (u == v) ? 0 : off[v + 1] - off[v];
    int64_t ia = 0, ib = 0;
    int32_t prev = -1;
    while (ia < na || ib < nb) {
      int32_t j;
      if (ib >= nb || (ia < na && a[ia] <= b[ib])) {
        j = a[ia++];
      } else {
        j = b[ib++];
      }
      if (j == prev) continue;
      prev = j;
      // shared-set size between edge i and edge j
      const int32_t p = src[j], q = dst[j];
      int shared = 0;
      if (u == p || u == q) ++shared;
      if (v != u && (v == p || v == q)) ++shared;
      // sets: if p == q the j-side is a singleton; the count above already
      // treats membership set-wise on the i side; clamp j side:
      if (p == q && shared == 2) shared = 1;
      if (shared == 1) {
        if (n_out >= cap) return -1;
        out0[n_out] = static_cast<int32_t>(i);
        out1[n_out] = static_cast<int32_t>(j);
        ++n_out;
      }
    }
  }
  return n_out;
}

// TCSR window metadata (see ops/tcsr.py for the contract).
// Writes ew_blk/sw_tile (n_tiles) and flat (n_edges); returns 0 on success,
// -1 if a kept edge falls outside its pinned window after clamping.
// n_chunks/k_src: pass 0 to auto-size (the measured maxima are written back
// through max_chunks/max_k either way).
int32_t tile_meta(int64_t n_edges, const int32_t* src, const int32_t* dst,
                  const float* mask, int64_t n_nodes, int32_t tn, int32_t te,
                  int32_t n_chunks, int32_t k_src, int32_t* ew_blk,
                  int32_t* sw_tile, int32_t* flat, int32_t* max_chunks,
                  int32_t* max_k) {
  const int64_t n_tiles = n_nodes / tn;
  const int64_t n_eblk = n_edges / te;
  std::vector<int64_t> e_lo(n_tiles, -1), e_hi(n_tiles, -1);
  std::vector<int64_t> s_lo(n_tiles, -1), s_hi(n_tiles, -1);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (mask[e] <= 0.f) continue;
    const int64_t t = dst[e] / tn;
    if (e_lo[t] < 0 || e < e_lo[t]) e_lo[t] = e;
    if (e > e_hi[t]) e_hi[t] = e;
    if (s_lo[t] < 0 || src[e] < s_lo[t]) s_lo[t] = src[e];
    if (src[e] > s_hi[t]) s_hi[t] = src[e];
  }
  int32_t mc = 1, mk = 1;
  for (int64_t t = 0; t < n_tiles; ++t) {
    if (e_lo[t] < 0) {
      ew_blk[t] = 0;
      sw_tile[t] = 0;
      continue;
    }
    ew_blk[t] = static_cast<int32_t>(e_lo[t] / te);
    sw_tile[t] = static_cast<int32_t>(s_lo[t] / tn);
    const int32_t c = static_cast<int32_t>(e_hi[t] / te) - ew_blk[t] + 1;
    const int32_t k = static_cast<int32_t>(s_hi[t] / tn) - sw_tile[t] + 1;
    if (c > mc) mc = c;
    if (k > mk) mk = k;
  }
  *max_chunks = mc;
  *max_k = mk;
  if (n_chunks == 0) n_chunks = mc;
  if (k_src == 0) k_src = mk;
  if (mc > n_chunks || mk > k_src) return -1;
  if (n_chunks > n_eblk || k_src > n_tiles) return -1;
  for (int64_t t = 0; t < n_tiles; ++t) {
    if (ew_blk[t] > n_eblk - n_chunks)
      ew_blk[t] = static_cast<int32_t>(n_eblk - n_chunks);
    if (sw_tile[t] > n_tiles - k_src)
      sw_tile[t] = static_cast<int32_t>(n_tiles - k_src);
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    if (mask[e] <= 0.f) {
      flat[e] = 0;
      continue;
    }
    const int64_t t = dst[e] / tn;
    const int64_t lo = static_cast<int64_t>(ew_blk[t]) * te;
    if (e < lo || e >= lo + static_cast<int64_t>(n_chunks) * te) return -1;
    const int64_t s0 = static_cast<int64_t>(sw_tile[t]) * tn;
    if (src[e] < s0 || src[e] >= s0 + static_cast<int64_t>(k_src) * tn)
      return -1;
    flat[e] = static_cast<int32_t>(t * (static_cast<int64_t>(n_chunks) * te) +
                                   (e - lo));
  }
  return 0;
}

}  // extern "C"
