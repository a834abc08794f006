// Dense-attr GAT backward pass, part 1 (atom, frag and fconn levels under the
// dense-attr kernel policy), for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_attr_bwd_kernel
// (l.276), pallas_call at l.515, called from the custom VJP op_bwd (l.595).
// For tile t of tn nodes, row i = destination, column j = source, with
// W_h[i, j] the w_ea[e, h] of the counted edge at slot (i, j) as in
// dense_attr_fwd.cu, given the forward's inputs, its softmax state (m, den),
// the cotangent g of out and s = sum_d g * out per node and head:
//   zpre   = (wd[i,h] + ws[j,h]) + W_h[i,j]
//   P      = exp(leaky(zpre) - m[i,h]) * adj / den[i,h]   where adj > 0, else 0
//   d_zpre = P * (sum_d g[i,h,d] * nf[j,h,d] - s[i,h]) * (zpre > 0 ? 1 : slope) * adj
// it emits
//   d_wd[i,h]    = sum_j d_zpre
//   d_ws[j,h]    = sum_i d_zpre
//   d_nf[j]      = sum_i P[i,j] * g[i]  (+ ps[j] * g[j] with self_loops)
//   d_wself[i,h] = ps * (sum_d g[i]*nf[i] - s) * (zs_pre > 0 ? 1 : slope)
//                  with ps = exp(leaky(zs_pre) - m) / den, zs_pre = wd[i]+ws[i]
//                  (0 without self_loops)
//   dz[t, h*tn + i, j] = d_zpre          (every slot written: 0 off the
//                                         adjacency, so dense_attr_emit.cu
//                                         and a comparison read any slot)
// den == 0 counts as 1. The self-loop terms of d_wd/d_ws, d_nf += d_wd x
// a_dst + d_ws x a_src and d_a are left to torch outside the kernel, as the
// TPU op_bwd leaves them outside Pallas (l.612-622).
//
// What bounds it on this card: the dz planes it writes (H*tn*tn*4 bytes per
// tile: 256 KiB at tn = 128, H = 4), the adjacency it reads (tn*tn*4), and
// per nonzero one g row and one nf row. Few flops per byte; at the 2-6
// tiles a level of the finetune batch the kernel is bound by latency: how
// many SMs have work and how many rounds of dependent loads each warp waits
// on. The first port (a block per (tile, 32 rows): 24 blocks at the
// finetune atom level, 8 at frag and fconn; a serial fill of a 32 x tn slot
// table; per nonzero a loop over heads with lanes along D; d_ws and d_nf by
// f32 atomics into zero-filled outputs) ran at 3% of its byte bound and
// gave last-bit differences from run to run.
//
// Design: one launch, two roles, no atomics; every output element is
// written once, by its owner, in a fixed order, so the result is the same
// from run to run and no output needs a zero fill. A block of kRows warps
// takes one slice of kRows rows (or columns) of one tile, a warp one row
// (column); lanes run along H*D with float4 loads (a lane's four columns
// lie in one head), kUnroll nonzeros' loads in flight before any is folded
// in. Each block finds its slice's edges by scanning the tile's window once
// in rounds of kThreads edges, each thread one edge, and recording the
// counted ones in a kRows x tn map of edge ids in shared memory (row of the
// slice, other end in the tile); the map is cleared before the scan, so a
// nonzero of the adjacency without a counted edge reads -1 (W = 0), as the
// plain version's W planes give.
//   * Row role (d_wd, d_wself, the dz planes): the warp reads its adjacency
//     row once in float4 and lists its nonzero columns in column order by
//     ballots (as dense_gat_fwd.cu does). Per nonzero it recomputes P from
//     (m, den) and d_zpre from the per-head dot g[i]·nf[j], sums d_wd in
//     column order and stores d_zpre at its slot; the row's H x tn slots
//     are first cleared with coalesced float4 stores.
//   * Column role (d_ws, d_nf): the warp reads column j of the adjacency
//     (one strided load per 32 rows, all in flight) and lists its nonzero
//     rows in row order; per nonzero row it recomputes P and d_zpre from
//     that row's g, wd, m, den and s (as dense_gat_bwd.cu's column role
//     does) and sums d_ws and P·g[i] in row order, then the self-loop.
// Both roles compute P and d_zpre with the same expressions, so they agree
// bit for bit. The per-head dot is summed in the order in which torch sums
// s = (g * out).sum(-1) on the card (DenseAttrGatFn's s, a plain torch sum;
// halves, as tcsr_gat_bwd.cu sums): where a row has one neighbour and no
// self-loop, out == nf[j] bit for bit (dense_attr_fwd.cu divides), so
// d_p - s is exactly 0 and so are d_zpre, d_wd, d_ws and the emitted d_wea,
// as the math says. The TPU kernel's one-hot matmuls that rebuild the dense
// W planes chunk by chunk (Mosaic has no cheap indexed load) are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;              // rows (columns) per block, a warp each
constexpr int kThreads = 32 * kRows;  // also the window edges of one round
constexpr int kUnroll = 4;            // nonzeros whose loads a warp has in flight
constexpr int kMaxTn = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* adj;     // (n_tiles, tn, tn), tile stride adj_stride
  const float* wd;      // (N, H)
  const float* ws;      // (N, H)
  const float* nf;      // (N, H*D)
  const float* w_ea;    // (E, H)
  const int* src;       // (E,)
  const int* dst;       // (E,)
  const float* emask;   // (E,)
  const int* ew_blk;    // (n_tiles,) window starts, te blocks
  const int* cw;        // (n_tiles,) window widths, te blocks
  const float* m;       // (N, H)
  const float* den;     // (N, H)
  const float* g;       // (N, H*D)
  const float* s;       // (N, H)
  float* d_wd;          // (N, H)
  float* d_ws;          // (N, H)
  float* d_wself;       // (N, H)
  float* d_nf;          // (N, H*D)
  float* dz;            // (n_tiles, H*tn, tn)
  long long adj_stride;
  int n_tiles, n_edges, tn, te, H, D, self_loops;
  float slope;
};

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The per-head dot in the order of torch's sum over the last dimension on
// the card for D <= 64 (as tcsr_gat_bwd.cu): rounded products, then halves,
// column c + column c ^ (D/2) first, down to c ^ 1. A lane holds four
// adjacent columns of the head's w lanes (w a power of two, segments
// aligned): column offsets >= 4 are shuffles at lane offset / 4, each
// column of the four on its own, and 2 and 1 are within the lane.
__device__ __forceinline__ float head_dot(float4 a, float4 b, int w) {
  float x = __fmul_rn(a.x, b.x), y = __fmul_rn(a.y, b.y),
        z = __fmul_rn(a.z, b.z), t = __fmul_rn(a.w, b.w);
  for (int o = w >> 1; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
    y = __fadd_rn(y, __shfl_xor_sync(kFull, y, o));
    z = __fadd_rn(z, __shfl_xor_sync(kFull, z, o));
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, o));
  }
  return __fadd_rn(__fadd_rn(x, z), __fadd_rn(y, t));
}

// d_zpre (returned) and P of one (i, j) pair for the lane's head, from
// zpre's parts (wd[i] + ws[j], then the edge's w_ea) in the forward's
// association. Called by the whole warp.
__device__ __forceinline__ float pair_grad(float wdi, float wsj, float wea,
                                           float aij, float m, float dg,
                                           float s, float4 gi, float4 xj,
                                           int w, float slope, float& p) {
  const float zp = (wdi + wsj) + wea;
  p = expf(leaky(zp, slope) - m) * aij / dg;
  const float dp = head_dot(gi, xj, w);
  return p * (dp - s) * (zp > 0.f ? 1.f : slope) * aij;
}

// One window edge as a thread of the block reads it, before it is recorded.
struct WinEdge {
  int near, far;  // the end in the slice, the other end
  bool keep;
};

__device__ __forceinline__ WinEdge read_edge(const Args& a, int e, int e_hi,
                                             bool near_is_dst) {
  WinEdge w{0, 0, false};
  if (e < e_hi) {
    const int d = a.dst[e], s = a.src[e];
    w.keep = a.emask[e] > 0.f;
    w.near = near_is_dst ? d : s;
    w.far = near_is_dst ? s : d;
  }
  return w;
}

// map[r][c] = e for a counted edge whose near end is node near0 + r (r <
// kRows) and whose far end is node node0 + c (c < tn)
__device__ __forceinline__ void record(const WinEdge& w, int e, int near0,
                                       int node0, int tn,
                                       int (*map)[kMaxTn]) {
  const int r = w.near - near0, c = w.far - node0;
  if (w.keep && r >= 0 && r < kRows && c >= 0 && c < tn) map[r][c] = e;
}

template <int NV>  // float4 column groups per lane: H*D <= 128 * NV
__global__ void __launch_bounds__(kThreads) dense_attr_bwd_kernel(
    const Args a, int n_row_blocks) {
  __shared__ int lst[kRows][kMaxTn];    // a warp's nonzero columns (rows)
  __shared__ float val[kRows][kMaxTn];  // their adjacency values
  __shared__ int eid[kRows][kMaxTn];    // the edge at each slot of the slice

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = a.tn, H = a.H, HD = a.H * a.D, W = a.D >> 2;
  const float slope = a.slope;
  const bool col_role = (int)blockIdx.x >= n_row_blocks;
  const int b = col_role ? blockIdx.x - n_row_blocks : blockIdx.x;
  const int slices = tn / kRows;
  const int t = b / slices;
  const int node0 = t * tn;                  // the tile's first node
  const int near0 = node0 + (b % slices) * kRows;  // the slice's first node
  const int mine = near0 - node0 + warp;     // this warp's row (column)
  const size_t node = (size_t)node0 + mine;
  const float* tile = a.adj + (size_t)t * a.adj_stride;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  int col[NV], hd[NV];
  bool on[NV], first[NV];  // first: the head's first lane writes its scalars
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / a.D : 0;
    first[v] = on[v] && col[v] % a.D == 0;
  }

  // the slice's map cleared; the first round of the window requested
  for (int q = tid; q < kRows * tn; q += kThreads) eid[q / tn][q % tn] = -1;
  const int e_lo = a.ew_blk[t] * a.te;
  const int e_hi = min(e_lo + a.cw[t] * a.te, a.n_edges);
  const WinEdge w0 = read_edge(a, e_lo + tid, e_hi, !col_role);

  if (!col_role) {
    // ---- row role: d_wd, d_wself and the row's dz slots ------------------
    const float* arow = tile + (size_t)mine * tn;
    float4 ad[kMaxTn / 128];
#pragma unroll
    for (int k = 0; k < kMaxTn / 128; ++k) {
      const int c = 128 * k + 4 * lane;
      ad[k] = c < tn ? ld4(arow + c) : zero4;
    }
    float4 gi[NV], xi[NV];
    float wdi[NV], wsi[NV], mi[NV], dgi[NV], si[NV], dwd[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      gi[v] = on[v] ? ld4(a.g + node * HD + col[v]) : zero4;
      xi[v] = on[v] && a.self_loops ? ld4(a.nf + node * HD + col[v]) : zero4;
      wdi[v] = a.wd[node * H + hd[v]];
      wsi[v] = a.ws[node * H + hd[v]];
      mi[v] = a.m[node * H + hd[v]];
      const float dn = a.den[node * H + hd[v]];
      dgi[v] = dn == 0.f ? 1.f : dn;
      si[v] = a.s[node * H + hd[v]];
      dwd[v] = 0.f;
    }
    // the row's slots of every head plane cleared, coalesced
    float* dzt = a.dz + (size_t)t * H * tn * tn;
    for (int q = lane; q < H * (tn >> 2); q += 32) {
      const int h = q / (tn >> 2), c = 4 * (q % (tn >> 2));
      *reinterpret_cast<float4*>(dzt + ((size_t)h * tn + mine) * tn + c) =
          zero4;
    }
    __syncthreads();  // the map is clear
    record(w0, e_lo + tid, near0, node0, tn, eid);
    for (int e = e_lo + tid + kThreads; e < e_hi; e += kThreads)
      record(read_edge(a, e, e_hi, true), e, near0, node0, tn, eid);
    __syncthreads();  // the map is complete; the cleared slots are stored

    // the row's nonzero columns, in column order
    const unsigned below = (1u << lane) - 1u;
    int n = 0;
#pragma unroll
    for (int k = 0; k < kMaxTn / 128; ++k) {
      if (128 * k >= tn) break;
      const int c = 128 * k + 4 * lane;
      const float4 q = ad[k];
      const unsigned b0 = __ballot_sync(kFull, q.x > 0.f);
      const unsigned b1 = __ballot_sync(kFull, q.y > 0.f);
      const unsigned b2 = __ballot_sync(kFull, q.z > 0.f);
      const unsigned b3 = __ballot_sync(kFull, q.w > 0.f);
      int pos = n + __popc(b0 & below) + __popc(b1 & below)
                + __popc(b2 & below) + __popc(b3 & below);
      if (q.x > 0.f) { lst[warp][pos] = c; val[warp][pos++] = q.x; }
      if (q.y > 0.f) { lst[warp][pos] = c + 1; val[warp][pos++] = q.y; }
      if (q.z > 0.f) { lst[warp][pos] = c + 2; val[warp][pos++] = q.z; }
      if (q.w > 0.f) { lst[warp][pos] = c + 3; val[warp][pos++] = q.w; }
      n += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
    __syncwarp();

    for (int b0 = 0; b0 < n; b0 += kUnroll) {
      int js[kUnroll];
      float aj[kUnroll];
      float4 x[kUnroll][NV];
      float wsj[kUnroll][NV], wea[kUnroll][NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = b0 + u < n;
        js[u] = ok ? lst[warp][b0 + u] : 0;
        aj[u] = ok ? val[warp][b0 + u] : 0.f;
        const int e = ok ? eid[warp][js[u]] : -1;
        const size_t nj = (size_t)node0 + js[u];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          x[u][v] = ok && on[v] ? ld4(a.nf + nj * HD + col[v]) : zero4;
          wsj[u][v] = a.ws[nj * H + hd[v]];
          wea[u][v] = e >= 0 ? a.w_ea[(size_t)e * H + hd[v]] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u >= n) break;  // warp-uniform
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float p;
          const float dzv = pair_grad(wdi[v], wsj[u][v], wea[u][v], aj[u],
                                      mi[v], dgi[v], si[v], gi[v], x[u][v],
                                      W, slope, p);
          dwd[v] += dzv;
          if (first[v]) dzt[((size_t)hd[v] * tn + mine) * tn + js[u]] = dzv;
        }
      }
    }

#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float dself = 0.f;
      if (a.self_loops) {
        const float zs = wdi[v] + wsi[v];
        const float ps = expf(leaky(zs, slope) - mi[v]) / dgi[v];
        const float dps = head_dot(gi[v], xi[v], W);
        dself = ps * (dps - si[v]) * (zs > 0.f ? 1.f : slope);
      }
      if (first[v]) {
        a.d_wd[node * H + hd[v]] = dwd[v];
        a.d_wself[node * H + hd[v]] = dself;
      }
    }
    return;
  }

  // ---- column role: d_ws and d_nf -----------------------------------------
  float ac[kMaxTn / 32];  // column `mine` of the adjacency, row lane + 32k
#pragma unroll
  for (int k = 0; k < kMaxTn / 32; ++k) {
    const int r = lane + 32 * k;
    ac[k] = r < tn ? tile[(size_t)r * tn + mine] : 0.f;
  }
  float4 xj[NV], gj[NV], dnf[NV];
  float wsj[NV], wdj[NV], mj[NV], dgj[NV], dws[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    xj[v] = on[v] ? ld4(a.nf + node * HD + col[v]) : zero4;
    gj[v] = on[v] && a.self_loops ? ld4(a.g + node * HD + col[v]) : zero4;
    wsj[v] = a.ws[node * H + hd[v]];
    wdj[v] = a.wd[node * H + hd[v]];
    mj[v] = a.m[node * H + hd[v]];
    const float dn = a.den[node * H + hd[v]];
    dgj[v] = dn == 0.f ? 1.f : dn;
    dnf[v] = zero4;
    dws[v] = 0.f;
  }
  __syncthreads();  // the map is clear
  record(w0, e_lo + tid, near0, node0, tn, eid);
  for (int e = e_lo + tid + kThreads; e < e_hi; e += kThreads)
    record(read_edge(a, e, e_hi, false), e, near0, node0, tn, eid);
  __syncthreads();  // the map is complete

  // the column's nonzero rows, in row order
  int n = 0;
#pragma unroll
  for (int k = 0; k < kMaxTn / 32; ++k) {
    if (32 * k >= tn) break;
    const unsigned bal = __ballot_sync(kFull, ac[k] > 0.f);
    if (ac[k] > 0.f) {
      const int pos = n + __popc(bal & ((1u << lane) - 1u));
      lst[warp][pos] = lane + 32 * k;
      val[warp][pos] = ac[k];
    }
    n += __popc(bal);
  }
  __syncwarp();

  for (int b0 = 0; b0 < n; b0 += kUnroll) {
    float ai[kUnroll];
    float4 gu[kUnroll][NV];
    float wdu[kUnroll][NV], mu[kUnroll][NV], dgu[kUnroll][NV],
        su[kUnroll][NV], wea[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = b0 + u < n;
      const int i = ok ? lst[warp][b0 + u] : 0;
      ai[u] = ok ? val[warp][b0 + u] : 0.f;
      const int e = ok ? eid[warp][i] : -1;
      const size_t ni = (size_t)node0 + i;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        gu[u][v] = ok && on[v] ? ld4(a.g + ni * HD + col[v]) : zero4;
        wdu[u][v] = a.wd[ni * H + hd[v]];
        mu[u][v] = a.m[ni * H + hd[v]];
        const float dn = a.den[ni * H + hd[v]];
        dgu[u][v] = dn == 0.f ? 1.f : dn;
        su[u][v] = a.s[ni * H + hd[v]];
        wea[u][v] = e >= 0 ? a.w_ea[(size_t)e * H + hd[v]] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b0 + u >= n) break;  // warp-uniform
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float p;
        dws[v] += pair_grad(wdu[u][v], wsj[v], wea[u][v], ai[u], mu[u][v],
                            dgu[u][v], su[u][v], gu[u][v], xj[v], W, slope,
                            p);
        dnf[v].x += p * gu[u][v].x;
        dnf[v].y += p * gu[u][v].y;
        dnf[v].z += p * gu[u][v].z;
        dnf[v].w += p * gu[u][v].w;
      }
    }
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (a.self_loops) {
      const float ps = expf(leaky(wdj[v] + wsj[v], slope) - mj[v]) / dgj[v];
      dnf[v].x += ps * gj[v].x;
      dnf[v].y += ps * gj[v].y;
      dnf[v].z += ps * gj[v].z;
      dnf[v].w += ps * gj[v].w;
    }
    if (!on[v]) continue;
    *reinterpret_cast<float4*>(a.d_nf + node * HD + col[v]) = dnf[v];
    if (first[v]) a.d_ws[node * H + hd[v]] = dws[v];
  }
}

}  // namespace

extern "C" int dense_attr_bwd(
    const void* adj, const void* wd, const void* ws, const void* nf,
    const void* w_ea, const void* src, const void* dst, const void* emask,
    const void* ew_blk, const void* cw, const void* m, const void* den,
    const void* g, const void* s, void* d_wd, void* d_ws, void* d_wself,
    void* d_nf, void* dz, long long adj_stride, int n_tiles, int tn, int H,
    int D, int E, int te, int self_loops, float slope, void* stream) {
  // lanes read the adjacency rows, nf and g in float4 and sum a head's D/4
  // lanes by shuffles: D/4 a power of two up to 32, H*D <= 256; tn in {32,
  // 64, 128, 256} (slices of kRows rows, float4 adjacency rows)
  const int w = D / 4;
  if ((tn != 32 && tn != 64 && tn != 128 && tn != 256) || H <= 0 || D % 4
      || w < 1 || w > 32 || (w & (w - 1)) || H * D > 256 || n_tiles < 0
      || E < 0 || te <= 0 || adj_stride % 4)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const Args a = {(const float*)adj, (const float*)wd, (const float*)ws,
                  (const float*)nf, (const float*)w_ea, (const int*)src,
                  (const int*)dst, (const float*)emask, (const int*)ew_blk,
                  (const int*)cw, (const float*)m, (const float*)den,
                  (const float*)g, (const float*)s, (float*)d_wd,
                  (float*)d_ws, (float*)d_wself, (float*)d_nf, (float*)dz,
                  adj_stride, n_tiles, E, tn, te, H, D, self_loops, slope};
  const int n_row = n_tiles * (tn / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  if (H * D <= 128)
    dense_attr_bwd_kernel<1><<<2 * n_row, kThreads, 0, st>>>(a, n_row);
  else
    dense_attr_bwd_kernel<2><<<2 * n_row, kThreads, 0, st>>>(a, n_row);
  return (int)cudaGetLastError();
}

extern "C" const char* dense_attr_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
