// Fused TCSR GAT forward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/pallas_gat.py:_fwd_kernel (l.105),
// built by _build (l.361) and entered through pallas_gat_pass (l.563). Same
// function: for every destination tile of tn nodes, walk the tile's edge
// window [ew_blk[t]*te, (ew_blk[t]+cw[t])*te) and compute
//   z   = leaky(w_dst[dst] + w_src[src] + w_ea[e])        (per head)
//   m   = max_e z (and the analytic self-loop logit when self_loops)
//   den = sum_e exp(z - m),  out = sum_e exp(z - m) * nf[src] / den
// emitting out (N, H*D), m (N, H) and den (N, H). A row with no edge and no
// self-loop comes out with m = -1e30, den = 0, out = 0.
//
// What bounds it on this card: the irregular reads of nf[src] rows (H*D f32
// per edge) and the per-edge scalars, a few flops per byte. At the batch
// sizes of the training and eval paths the bytes are tens of KB, so the
// kernel is bound by latency: how many dependent rounds of loads a block
// waits on, and how many SMs have a block at all. A block per tile (the
// first port of this kernel) gave 2-6 blocks on 132 SMs, each a chain of
// shared-memory CAS maxima, staging passes and shared atomics behind
// barriers.
//
// Design: a block takes one slice of kRows destination rows of one tile
// (grid: tn / kRows slices x tiles), a warp per row. The block scans the
// tile's real window once, in rounds of kThreads edges: each thread tests
// one edge (kept, destination in this slice; the window also holds edges
// of the neighbouring tiles, and edges need not be sorted by destination),
// and the kept edges are compacted into shared memory in edge order by a
// ballot and a prefix over the warps (no atomics). Each warp then picks its
// row's edges from the round by ballot and runs a single-pass online
// softmax: lanes along H*D with float4 nf[src] loads (a lane's four columns
// lie in one head, so each lane keeps its head's running max and
// denominator in registers), kUnroll edges' loads in flight before any of
// them is folded in, seeded with the self-loop logit when self_loops. out,
// m and den are written once. The summation order is fixed per row, so the
// result is the same from run to run. The TPU kernel's one-hot matmul
// gathers and k_src source windows (Mosaic has no cheap indexed load) are
// not carried over: nf[src] is read directly.
//
// tcsr_gat_ep_fwd (K3's forward) is the same kernel on one edge shard of
// the edge-partitioned pass. It replaces the TPU kernel built by
// fragnet_tpu/ops/pallas_gat.py:_make_ep_op (l.635) — _fwd_kernel at
// n_tiles_grid = Tg, reading the absolute tile t0 + t (l.116) — and entered
// through pallas_gat_pass_ep (l.750). The grid is the shard's Tg tiles
// starting at tile t0 (read from device memory, so the caller never waits
// for it); the edge arrays and the windows ew_blk / cw are the shard's,
// node arrays stay whole, and row i of out, m, den holds absolute node
// t0 * tn + i. No self-loops: the combine adds them once.
//
// tcsr_gat_fwd_bf16 is the same kernel with nf in bf16, the node-feature
// type of the JAX package's bf16 compute (pallas_gat.py:_build's dt_name,
// l.361-364): a lane reads its four columns as one 8-byte load and widens
// them to f32 exactly; wn, w_ea, the softmax and the sums stay f32, and out,
// m, den are written in f32 as in the f32 form. It halves the bytes of the
// nf[src] gathers, the kernel's largest reads. tcsr_gat_ep_fwd_bf16 is
// K3's forward with nf in bf16 (pallas_gat.py:_make_ep_op's dt_name, from
// the node features' dtype, l.786): the same bf16 instance on the shard's
// grid, no kernel of its own.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned short bf16_bits;  // one bf16 value, as stored

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 8;              // destination rows per block, a warp each
constexpr int kThreads = 32 * kRows;  // also the window edges of one round
constexpr int kUnroll = 4;            // edges whose loads a warp has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

// four adjacent columns of a node-feature row, as f32: one 16-byte load of
// f32, or one 8-byte load of bf16 widened exactly (a bf16 is the high half
// of its f32)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16_bits* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// NV: float4 column groups per lane (H*D <= 128 * NV); T: nf's element type
template <int NV, typename T>
__global__ void __launch_bounds__(kThreads) tcsr_gat_fwd_kernel(
    const float* __restrict__ wn,      // (N, 2H): [w_dst | w_src]
    const T* __restrict__ nf,          // (N, H*D), f32 or bf16
    const float* __restrict__ w_ea,    // (E, H)
    const int* __restrict__ src,       // (E,)
    const int* __restrict__ dst,       // (E,)
    const float* __restrict__ emask,   // (E,)
    const int* __restrict__ t0,        // (1,) first grid tile, or null: 0
    const int* __restrict__ ew_blk,    // (n_grid,)
    const int* __restrict__ cw,        // (n_grid,)
    float* __restrict__ out,           // (n_grid * tn, H*D)
    float* __restrict__ m_out,         // (n_grid * tn, H)
    float* __restrict__ den_out,       // (n_grid * tn, H)
    int tn, int te, int H, int D, int self_loops, float slope) {
  __shared__ int st_row[kThreads];  // a staged edge's row in the slice
  __shared__ int st_src[kThreads];
  __shared__ int st_eid[kThreads];
  __shared__ int st_count[kRows];   // staged edges per warp of the round

  const int t = blockIdx.y;
  const int r0 = blockIdx.x * kRows;              // the slice's first row
  const int node0 = ((t0 ? t0[0] : 0) + t) * tn;  // absolute first node
  const int e_lo = ew_blk[t] * te;
  const int e_hi = e_lo + cw[t] * te;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = H * D;
  const int node = node0 + r0 + warp;             // this warp's row
  const size_t orow = (size_t)t * tn + r0 + warp;  // its output row

  int col[NV], hd[NV];
  bool on[NV];
  float wdst[NV], mx[NV], dn[NV];
  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / D : 0;
    const float* w = wn + (size_t)node * 2 * H;
    wdst[v] = w[hd[v]];
    if (self_loops) {
      mx[v] = leaky(wdst[v] + w[H + hd[v]], slope);
      dn[v] = 1.f;
      acc[v] = on[v] ? ld4(nf + (size_t)node * HD + col[v])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      mx[v] = kNeg;
      dn[v] = 0.f;
      acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int base = e_lo; base < e_hi; base += kThreads) {
    // stage this round's edges of the slice, in edge order
    const int e = base + tid;
    int row = -1, s = 0;
    if (e < e_hi) {
      const int dl = dst[e] - node0 - r0;
      if (dl >= 0 && dl < kRows && emask[e] > 0.f) {
        row = dl;
        s = src[e];
      }
    }
    const unsigned kept = __ballot_sync(kFull, row >= 0);
    if (lane == 0) st_count[warp] = __popc(kept);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      const int c = st_count[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (row >= 0) {
      const int i = off + __popc(kept & ((1u << lane) - 1u));
      st_row[i] = row;
      st_src[i] = s;
      st_eid[i] = e;
    }
    __syncthreads();

    // this warp's edges of the round, kUnroll at a time
    for (int i0 = 0; i0 < total; i0 += 32) {
      const int i = i0 + lane;
      unsigned mine = __ballot_sync(kFull, i < total && st_row[i] == warp);
      while (mine) {
        int ss[kUnroll], ee[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ok[u] = mine != 0;
          const int b = ok[u] ? __ffs(mine) - 1 : 0;
          mine &= mine - 1;
          ss[u] = ok[u] ? st_src[i0 + b] : 0;
          ee[u] = ok[u] ? st_eid[i0 + b] : 0;
        }
        float4 x[kUnroll][NV];
        float zs[kUnroll][NV];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            x[u][v] = ok[u] && on[v] ? ld4(nf + (size_t)ss[u] * HD + col[v])
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            zs[u][v] = ok[u] ? wn[(size_t)ss[u] * 2 * H + H + hd[v]]
                               + w_ea[(size_t)ee[u] * H + hd[v]]
                             : 0.f;
          }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;  // warp-uniform
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float z = leaky(wdst[v] + zs[u][v], slope);
            const float mn = fmaxf(mx[v], z);
            const float a = expf(mx[v] - mn), p = expf(z - mn);
            dn[v] = dn[v] * a + p;
            acc[v].x = acc[v].x * a + p * x[u][v].x;
            acc[v].y = acc[v].y * a + p * x[u][v].y;
            acc[v].z = acc[v].z * a + p * x[u][v].z;
            acc[v].w = acc[v].w * a + p * x[u][v].w;
            mx[v] = mn;
          }
        }
      }
    }
    __syncthreads();  // the next round reuses the stage
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!on[v]) continue;
    const float q = 1.f / (dn[v] == 0.f ? 1.f : dn[v]);
    *reinterpret_cast<float4*>(out + orow * HD + col[v]) = make_float4(
        acc[v].x * q, acc[v].y * q, acc[v].z * q, acc[v].w * q);
    if (col[v] % D == 0) {  // the first lane of its head
      m_out[orow * H + hd[v]] = mx[v];
      den_out[orow * H + hd[v]] = dn[v];
    }
  }
}

template <typename T>
int launch(const void* wn, const void* nf, const void* w_ea, const void* src,
           const void* dst, const void* emask, const void* t0,
           const void* ew_blk, const void* cw, void* out, void* m, void* den,
           int n_grid, int tn, int te, int H, int D, int self_loops,
           float slope, void* stream) {
  if (D % 4 || H * D > 256 || tn % kRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(tn / kRows, n_grid);
  cudaStream_t st = (cudaStream_t)stream;
  if (H * D <= 128)
    tcsr_gat_fwd_kernel<1, T><<<grid, kThreads, 0, st>>>(
        (const float*)wn, (const T*)nf, (const float*)w_ea, (const int*)src,
        (const int*)dst, (const float*)emask, (const int*)t0,
        (const int*)ew_blk, (const int*)cw, (float*)out, (float*)m,
        (float*)den, tn, te, H, D, self_loops, slope);
  else
    tcsr_gat_fwd_kernel<2, T><<<grid, kThreads, 0, st>>>(
        (const float*)wn, (const T*)nf, (const float*)w_ea, (const int*)src,
        (const int*)dst, (const float*)emask, (const int*)t0,
        (const int*)ew_blk, (const int*)cw, (float*)out, (float*)m,
        (float*)den, tn, te, H, D, self_loops, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tcsr_gat_fwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* ew_blk, const void* cw,
    void* out, void* m, void* den, int n_tiles, int tn, int te, int H,
    int D, int self_loops, float slope, void* stream) {
  return launch<float>(wn, nf, w_ea, src, dst, emask, nullptr, ew_blk, cw,
                       out, m, den, n_tiles, tn, te, H, D, self_loops, slope,
                       stream);
}

// nf in bf16 (8-byte aligned rows); every other argument as above
extern "C" int tcsr_gat_fwd_bf16(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* ew_blk, const void* cw,
    void* out, void* m, void* den, int n_tiles, int tn, int te, int H,
    int D, int self_loops, float slope, void* stream) {
  return launch<bf16_bits>(wn, nf, w_ea, src, dst, emask, nullptr, ew_blk,
                           cw, out, m, den, n_tiles, tn, te, H, D,
                           self_loops, slope, stream);
}

// K3's forward: one shard's grid of n_grid tiles from tile *t0 (device).
extern "C" int tcsr_gat_ep_fwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* t0, const void* ew_blk,
    const void* cw, void* out, void* m, void* den, int n_grid, int tn,
    int te, int H, int D, float slope, void* stream) {
  return launch<float>(wn, nf, w_ea, src, dst, emask, t0, ew_blk, cw, out,
                       m, den, n_grid, tn, te, H, D, 0, slope, stream);
}

// K3's forward with nf in bf16 (8-byte aligned rows); every other argument
// as above
extern "C" int tcsr_gat_ep_fwd_bf16(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* t0, const void* ew_blk,
    const void* cw, void* out, void* m, void* den, int n_grid, int tn,
    int te, int H, int D, float slope, void* stream) {
  return launch<bf16_bits>(wn, nf, w_ea, src, dst, emask, t0, ew_blk, cw,
                           out, m, den, n_grid, tn, te, H, D, 0, slope,
                           stream);
}

extern "C" const char* tcsr_gat_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_ep_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_ep_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
