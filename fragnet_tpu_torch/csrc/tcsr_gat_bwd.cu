// Fused TCSR GAT backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/pallas_gat.py:_bwd_kernel (l.199),
// called at l.425 from the custom VJP op_bwd (l.504). Given the forward's
// inputs and its softmax state (m, den), the cotangent g of out and
// s = sum_d g * out per node and head, for every kept edge e (dst in the
// destination tile, emask > 0) and head h:
//   zpre = w_dst[dst] + w_src[src] + w_ea[e],   p = exp(leaky(zpre) - m[dst]) / den[dst]
//   d_p  = sum_d g[dst,h,d] * nf[src,h,d]
//   d_zpre = p * (d_p - s[dst]) * (zpre > 0 ? 1 : slope)
// and it emits
//   d_w_ea[e]        = d_zpre                (only the owning tile writes it)
//   d_wn[dst, :H]   += d_zpre,   d_wn[src, H:] += d_zpre
//   d_nf[src]       += p * g[dst]
// plus, with self_loops, the analytic self-loop of every node n of the tile
// (p_self from zpre = w_dst[n] + w_src[n]): d_wn[n, :H] and d_wn[n, H:] both
// get d_zpre_self, and d_nf[n] += p_self * g[n] (pallas_gat.py:227-236).
// den == 0 counts as 1, as in the forward. The TPU kernel's d_a_src, d_nf_dst
// and d_wself outputs are not needed: d_wn[:, H:] is the per-source sum of
// d_zpre, so d_a_src = sum_n d_wn[n, H:] * nf[n] and the a_dst/a_src parts of
// d_nf are the transpose of the prologue, which autograd computes in torch.
//
// What bounds it on this card: the irregular reads of the g[dst] and nf[src]
// rows (H*D f32 each per edge) and the scattered f32 atomics into d_nf and
// d_wn; a few flops per byte. At the batch sizes of training a level is a
// handful of tiles, so latency (the dependent loads of each edge) dominates.
//
// Design: the TPU kernel's one-hot gathers, its tiled per-edge d_z (gathered
// back through flat_slot) and its source-window d_nf slabs (folded outside
// the kernel) exist because Mosaic has no cheap indexed load or scatter; here
// every sum goes straight to its place with global f32 atomics (d_wn, d_nf)
// or a plain store (d_w_ea), so sources anywhere in the node range (k_src > 1
// windows, batches that are not tile-aligned) need nothing special, and the
// outputs must be zeroed by the caller. A destination tile's real window
// [ew_blk[t]*te, (ew_blk[t]+cw[t])*te) is split over kSplit blocks; one warp
// per edge, lanes along H*D (coalesced 128-byte row reads), per-head
// scalars computed by lanes h < H and broadcast by shuffle; the head sums of
// g * nf are butterfly shuffles over the D lanes of each head. Since m and
// den come from the forward, one pass suffices (no max pass). Masked edges
// and other tiles' edges in the window are skipped, so their d_w_ea stays
// exactly 0. The atomics make the summation order vary between runs
// (last-bit differences).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 8;     // blocks per destination tile
constexpr int kMaxCols = 8;   // H*D <= 256: columns per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

// One gradient item, computed by one warp: a kept edge e (dst d, src s), or
// with e < 0 the self-loop of node d (s == d, no edge-attr term).
// m, den, g and s_in are read at row dr (d, less the grid's first row).
__device__ __forceinline__ void grad_item(
    int e, int d, int dr, int s, int lane,
    const float* __restrict__ wn, const float* __restrict__ nf,
    const float* __restrict__ w_ea, const float* __restrict__ m,
    const float* __restrict__ den, const float* __restrict__ g,
    const float* __restrict__ s_in, float* __restrict__ d_wn,
    float* __restrict__ d_nf, float* __restrict__ d_w_ea,
    int H, int D, float slope) {
  const int HD = H * D;
  // per-head scalars on lanes h < H
  float p = 0.f, pf = 0.f, sd = 0.f;
  if (lane < H) {
    float zp = wn[(size_t)d * 2 * H + lane] + wn[(size_t)s * 2 * H + H + lane];
    if (e >= 0) zp += w_ea[(size_t)e * H + lane];
    const float dg = den[(size_t)dr * H + lane];
    p = expf(leaky(zp, slope) - m[(size_t)dr * H + lane])
        / (dg == 0.f ? 1.f : dg);
    pf = p * (zp > 0.f ? 1.f : slope);
    sd = s_in[(size_t)dr * H + lane];
  }
  float gv[kMaxCols], dp[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = lane + 32 * k;
    gv[k] = 0.f;
    dp[k] = 0.f;
    if (c < HD) {
      gv[k] = g[(size_t)dr * HD + c];
      dp[k] = gv[k] * nf[(size_t)s * HD + c];
    }
  }
  // head sums of g * nf: every lane ends with the sum of its column's head
  if (D <= 32) {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (32 * k >= HD) break;  // warp-uniform
      for (int o = D >> 1; o > 0; o >>= 1)
        dp[k] += __shfl_xor_sync(kFull, dp[k], o);
    }
  } else {  // D a multiple of 32: a head spans D / 32 column groups
    float tot[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      tot[k] = dp[k];
      if (32 * k >= HD) continue;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tot[k] += __shfl_xor_sync(kFull, tot[k], o);
    }
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q)
        if ((32 * q) / D == (32 * k) / D) acc += tot[q];
      dp[k] = acc;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = lane + 32 * k;
    if (32 * k >= HD) break;  // warp-uniform
    const int h = min(c / D, H - 1);
    const float ph = __shfl_sync(kFull, p, h);
    const float pfh = __shfl_sync(kFull, pf, h);
    const float sdh = __shfl_sync(kFull, sd, h);
    if (c < HD) {
      atomicAdd(&d_nf[(size_t)s * HD + c], ph * gv[k]);
      if (c % D == 0) {
        const float dz = pfh * (dp[k] - sdh);
        if (e >= 0) d_w_ea[(size_t)e * H + h] = dz;
        atomicAdd(&d_wn[(size_t)d * 2 * H + h], dz);
        atomicAdd(&d_wn[(size_t)s * 2 * H + H + h], dz);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tcsr_gat_bwd_kernel(
    const float* __restrict__ wn,      // (N, 2H): [w_dst | w_src]
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ w_ea,    // (E, H)
    const int* __restrict__ src,       // (E,)
    const int* __restrict__ dst,       // (E,)
    const float* __restrict__ emask,   // (E,)
    const int* __restrict__ t0,        // (1,) first grid tile, or null: 0
    const int* __restrict__ ew_blk,    // (n_grid,)
    const int* __restrict__ cw,        // (n_grid,)
    const float* __restrict__ m,       // (n_grid * tn, H)
    const float* __restrict__ den,     // (n_grid * tn, H)
    const float* __restrict__ g,       // (n_grid * tn, H*D)
    const float* __restrict__ s_in,    // (n_grid * tn, H)
    float* __restrict__ d_wn,          // (N, 2H), zeroed
    float* __restrict__ d_nf,          // (N, H*D), zeroed
    float* __restrict__ d_w_ea,        // (E, H), zeroed
    int tn, int te, int H, int D, int self_loops, float slope) {
  const int t = blockIdx.x;
  const int r0 = (t0 ? t0[0] : 0) * tn;  // absolute node of grid row 0
  const int node0 = r0 + t * tn;
  const int e_lo = ew_blk[t] * te;
  const int e_hi = e_lo + cw[t] * te;
  const int lane = threadIdx.x & 31;
  const int n_warps = kThreads / 32 * kSplit;
  const int wg = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);

  for (int e = e_lo + wg; e < e_hi; e += n_warps) {
    const int d = dst[e];
    if (d < node0 || d >= node0 + tn || !(emask[e] > 0.f)) continue;
    grad_item(e, d, d - r0, src[e], lane, wn, nf, w_ea, m, den, g, s_in,
              d_wn, d_nf, d_w_ea, H, D, slope);
  }
  if (self_loops) {
    for (int i = wg; i < tn; i += n_warps)
      grad_item(-1, node0 + i, node0 + i - r0, node0 + i, lane, wn, nf,
                w_ea, m, den, g, s_in, d_wn, d_nf, d_w_ea, H, D, slope);
  }
}

int launch(const void* wn, const void* nf, const void* w_ea, const void* src,
           const void* dst, const void* emask, const void* t0,
           const void* ew_blk, const void* cw, const void* m, const void* den,
           const void* g, const void* s, void* d_wn, void* d_nf, void* d_w_ea,
           int n_grid, int tn, int te, int H, int D, int self_loops,
           float slope, void* stream) {
  const bool d_ok = D > 0 && (D <= 32 ? 32 % D == 0 : D % 32 == 0);
  if (H <= 0 || H > 32 || !d_ok || H * D > 32 * kMaxCols)
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_grid, kSplit);
  tcsr_gat_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wn, (const float*)nf, (const float*)w_ea,
      (const int*)src, (const int*)dst, (const float*)emask,
      (const int*)t0, (const int*)ew_blk, (const int*)cw, (const float*)m,
      (const float*)den, (const float*)g, (const float*)s, (float*)d_wn,
      (float*)d_nf, (float*)d_w_ea, tn, te, H, D, self_loops, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tcsr_gat_bwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* ew_blk, const void* cw,
    const void* m, const void* den, const void* g, const void* s,
    void* d_wn, void* d_nf, void* d_w_ea, int n_tiles, int tn, int te,
    int H, int D, int self_loops, float slope, void* stream) {
  return launch(wn, nf, w_ea, src, dst, emask, nullptr, ew_blk, cw, m, den,
                g, s, d_wn, d_nf, d_w_ea, n_tiles, tn, te, H, D, self_loops,
                slope, stream);
}

// K3's backward: one shard's grid of n_grid tiles from tile *t0 (device);
// m, den, g, s hold the grid's n_grid * tn rows.
extern "C" int tcsr_gat_ep_bwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* t0, const void* ew_blk,
    const void* cw, const void* m, const void* den, const void* g,
    const void* s, void* d_wn, void* d_nf, void* d_w_ea, int n_grid, int tn,
    int te, int H, int D, float slope, void* stream) {
  return launch(wn, nf, w_ea, src, dst, emask, t0, ew_blk, cw, m, den, g, s,
                d_wn, d_nf, d_w_ea, n_grid, tn, te, H, D, 0, slope, stream);
}

extern "C" const char* tcsr_gat_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_ep_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
