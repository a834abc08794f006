// Dense-attr GAT backward pass, part 1 (atom, frag and fconn levels under the
// dense-attr kernel policy), for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_attr_bwd_kernel
// (l.276), pallas_call at l.515, called from the custom VJP op_bwd (l.595).
// For tile t of tn nodes, row i = destination, column j = source, with
// W_h[i, j] the w_ea[e, h] of the counted edge at slot (i, j) as in
// dense_attr_fwd.cu, given the forward's inputs, its softmax state (m, den),
// the cotangent g of out and s = sum_d g * out per node and head:
//   zpre   = wd[i,h] + ws[j,h] + W_h[i,j]
//   P      = exp(leaky(zpre) - m[i,h]) * adj / den[i,h]   where adj > 0, else 0
//   d_zpre = P * (sum_d g[i,h,d] * nf[j,h,d] - s[i,h]) * (zpre > 0 ? 1 : slope) * adj
// it emits
//   d_wd[i,h]   = sum_j d_zpre            (plain store, one warp per row)
//   d_ws[j,h]  += sum_i d_zpre            (f32 atomics: caller zero-fills)
//   d_nf[j]    += sum_i P[i,j] * g[i]     (+ ps[j] * g[j] with self_loops;
//                                          f32 atomics: caller zero-fills)
//   d_wself[i,h] = ps * (sum_d g[i]*nf[i] - s) * (zs_pre > 0 ? 1 : slope)
//                  with ps = exp(leaky(zs_pre) - m) / den, zs_pre = wd[i]+ws[i]
//                  (0 without self_loops)
//   dz[t, h*tn + i, j] = d_zpre           (every slot written: 0 off the
//                                          adjacency, so dense_attr_emit.cu
//                                          and a comparison read any slot)
// den == 0 counts as 1. The self-loop terms of d_wd/d_ws, d_nf += d_wd x
// a_dst + d_ws x a_src and d_a are left to torch outside the kernel, as the
// TPU op_bwd leaves them outside Pallas (l.612-622).
//
// What bounds it on this card: the dz planes it writes (H*tn*tn*4 bytes per
// tile: 256 KiB at tn = 128, H = 4), the adjacency it reads (tn*tn*4), and
// per nonzero one g row and one nf row read and one d_nf row of atomics.
// Few flops per byte; at 2-6 tiles a level, latency.
//
// Design: the TPU kernel re-accumulates the dense W planes by one-hot
// matmuls over each window chunk, then runs the dense softmax backward on the
// last chunk. Here, as in dense_attr_fwd.cu, a block takes one (tile, group
// of kRows destination rows), records the edge id of each slot of its rows
// in shared memory (kRows x tn int32) from one scan of the tile's window,
// and a warp per row recomputes P from (m, den), each lane owning tn/32
// columns, so no plane of W exists. The row's nonzero columns are walked by
// warp ballot: per head the dot g[i]·nf[j] is a warp reduction with lanes
// along D, after which every lane knows d_zpre; d_wd accumulates in
// registers, d_ws and d_nf (column sums, which cross the row groups of a
// tile) go to global memory by f32 atomics, and the lane owning column j
// keeps d_zpre in the register that held P, so the dz row is written with
// one coalesced store per (column block, head) after the walk: P = 0
// exactly where adj = 0, so those slots get 0. The atomics make the
// summation order of d_ws and d_nf vary between runs (last-bit
// differences).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // destination rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int H, int JPL>  // JPL = tn / 32 columns per lane
__global__ void __launch_bounds__(kThreads) dense_attr_bwd_kernel(
    const float* __restrict__ adj,     // (n_tiles, tn, tn), tile stride adj_stride
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ w_ea,    // (E, H)
    const int32_t* __restrict__ src,   // (E,)
    const int32_t* __restrict__ dst,   // (E,)
    const float* __restrict__ emask,   // (E,)
    const int32_t* __restrict__ ew_blk,  // (n_tiles,)
    const int32_t* __restrict__ cw,      // (n_tiles,)
    const float* __restrict__ m,       // (N, H)
    const float* __restrict__ den,     // (N, H)
    const float* __restrict__ g,       // (N, H*D)
    const float* __restrict__ s_in,    // (N, H)
    float* __restrict__ d_wd,          // (N, H)
    float* __restrict__ d_ws,          // (N, H), zero-filled
    float* __restrict__ d_wself,       // (N, H)
    float* __restrict__ d_nf,          // (N, H*D), zero-filled
    float* __restrict__ dz,            // (n_tiles, H*tn, tn)
    long long adj_stride, int E, int te, int D, int self_loops,
    float slope) {
  constexpr int tn = 32 * JPL;
  extern __shared__ int32_t smem[];
  int32_t* slot = smem;                                  // kRows * tn
  float* ws_s = reinterpret_cast<float*>(slot + kRows * tn);  // tn * H

  const int t = blockIdx.x;
  const int node0 = t * tn;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int HD = H * D;
  for (int i = tid; i < kRows * tn; i += kThreads) slot[i] = -1;
  for (int i = tid; i < tn * H; i += kThreads)
    ws_s[i] = ws[(size_t)node0 * H + i];
  __syncthreads();
  const int e0 = ew_blk[t] * te;
  const int e1 = min(e0 + cw[t] * te, E);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    if (!(emask[e] > 0.f)) continue;
    const int d = dst[e] - node0 - row0;
    const int s = src[e] - node0;
    if (d < 0 || d >= kRows || s < 0 || s >= tn) continue;
    slot[d * tn + s] = e;
  }
  __syncthreads();

  const float* tile = adj + (size_t)t * adj_stride;
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int i = row0 + r;
    const int node = node0 + i;
    float wdi[H], mi[H], dgi[H], si[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      wdi[h] = wd[(size_t)node * H + h];
      mi[h] = m[(size_t)node * H + h];
      const float dn = den[(size_t)node * H + h];
      dgi[h] = dn == 0.f ? 1.f : dn;
      si[h] = s_in[(size_t)node * H + h];
    }
    // zp = zpre; p = P, later d_zpre at the columns this lane owns
    float a[JPL], zp[JPL][H], p[JPL][H];
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      const int j = lane + 32 * k;
      a[k] = tile[(size_t)i * tn + j];
      const int e = slot[r * tn + j];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        zp[k][h] = wdi[h] + ws_s[j * H + h]
                   + (e >= 0 ? w_ea[(size_t)e * H + h] : 0.f);
        p[k][h] = a[k] > 0.f
            ? expf(leaky(zp[k][h], slope) - mi[h]) * a[k] / dgi[h] : 0.f;
      }
    }

    float dwd[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dwd[h] = 0.f;
    const float* grow = g + (size_t)node * HD;
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      unsigned nz = __ballot_sync(kFull, a[k] > 0.f);
      while (nz) {
        const int b = __ffs(nz) - 1;
        nz &= nz - 1;
        const int j = 32 * k + b;
        const float aj = __shfl_sync(kFull, a[k], b);
        const float* nrow = nf + (size_t)(node0 + j) * HD;
        float* drow = d_nf + (size_t)(node0 + j) * HD;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float pj = __shfl_sync(kFull, p[k][h], b);
          const float zj = __shfl_sync(kFull, zp[k][h], b);
          float dp = 0.f;
          for (int d = lane; d < D; d += 32) {
            const float gv = grow[h * D + d];
            dp += gv * nrow[h * D + d];
            atomicAdd(&drow[h * D + d], pj * gv);
          }
          dp = warp_sum(dp);
          const float dzv = pj * (dp - si[h]) * (zj > 0.f ? 1.f : slope) * aj;
          dwd[h] += dzv;
          if (lane == 0) atomicAdd(&d_ws[(size_t)(node0 + j) * H + h], dzv);
          if (lane == b) p[k][h] = dzv;
        }
      }
    }

    float dself[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dself[h] = 0.f;
    if (self_loops) {
      const float* nown = nf + (size_t)node * HD;
      float* down = d_nf + (size_t)node * HD;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float zs_pre = wdi[h] + ws_s[i * H + h];
        const float ps = expf(leaky(zs_pre, slope) - mi[h]) / dgi[h];
        float dps = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float gv = grow[h * D + d];
          dps += gv * nown[h * D + d];
          atomicAdd(&down[h * D + d], ps * gv);
        }
        dps = warp_sum(dps);
        dself[h] = ps * (dps - si[h]) * (zs_pre > 0.f ? 1.f : slope);
      }
    }

    float* dzt = dz + (size_t)t * H * tn * tn;
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int k = 0; k < JPL; ++k)
        dzt[((size_t)h * tn + i) * tn + lane + 32 * k] = p[k][h];
      if (lane == h) {
        d_wd[(size_t)node * H + h] = dwd[h];
        d_wself[(size_t)node * H + h] = dself[h];
      }
    }
  }
}

struct Args {
  const float *adj, *wd, *ws, *nf, *w_ea;
  const int32_t *src, *dst;
  const float* emask;
  const int32_t *ew_blk, *cw;
  const float *m, *den, *g, *s;
  float *d_wd, *d_ws, *d_wself, *d_nf, *dz;
  long long adj_stride;
  int n_tiles, E, te, D, self_loops;
  float slope;
};

template <int H, int JPL>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int tn = 32 * JPL;
  const size_t smem = sizeof(int32_t) * kRows * tn + sizeof(float) * tn * H;
  cudaError_t err = cudaFuncSetAttribute(
      dense_attr_bwd_kernel<H, JPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.n_tiles == 0) return 0;
  dim3 grid(a.n_tiles, tn / kRows);
  dense_attr_bwd_kernel<H, JPL><<<grid, kThreads, smem, stream>>>(
      a.adj, a.wd, a.ws, a.nf, a.w_ea, a.src, a.dst, a.emask, a.ew_blk, a.cw,
      a.m, a.den, a.g, a.s, a.d_wd, a.d_ws, a.d_wself, a.d_nf, a.dz,
      a.adj_stride, a.E, a.te, a.D, a.self_loops, a.slope);
  return (int)cudaGetLastError();
}

template <int H>
int launch_tn(int tn, const Args& a, cudaStream_t s) {
  switch (tn) {
    case 32: return launch<H, 1>(a, s);
    case 64: return launch<H, 2>(a, s);
    case 128: return launch<H, 4>(a, s);
    case 256: return launch<H, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_attr_bwd(
    const void* adj, const void* wd, const void* ws, const void* nf,
    const void* w_ea, const void* src, const void* dst, const void* emask,
    const void* ew_blk, const void* cw, const void* m, const void* den,
    const void* g, const void* s, void* d_wd, void* d_ws, void* d_wself,
    void* d_nf, void* dz, long long adj_stride, int n_tiles, int tn, int H,
    int D, int E, int te, int self_loops, float slope, void* stream) {
  Args a{(const float*)adj, (const float*)wd, (const float*)ws,
         (const float*)nf, (const float*)w_ea, (const int32_t*)src,
         (const int32_t*)dst, (const float*)emask, (const int32_t*)ew_blk,
         (const int32_t*)cw, (const float*)m, (const float*)den,
         (const float*)g, (const float*)s, (float*)d_wd, (float*)d_ws,
         (float*)d_wself, (float*)d_nf, (float*)dz, adj_stride, n_tiles, E,
         te, D, self_loops, slope};
  cudaStream_t st = (cudaStream_t)stream;
  switch (H) {
    case 1: return launch_tn<1>(tn, a, st);
    case 2: return launch_tn<2>(tn, a, st);
    case 4: return launch_tn<4>(tn, a, st);
    case 8: return launch_tn<8>(tn, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_attr_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
