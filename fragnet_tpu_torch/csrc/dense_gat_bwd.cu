// Dense per-tile GAT backward pass over host-built planes, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_bwd_kernel (l.419),
// called at l.731 from the custom VJP op_bwd (l.785). For tile t of tn nodes
// with planes[t] = (adjacency, EA_1..EA_R), row i = destination, column j =
// source, given the forward's inputs and softmax state (m, den), the
// cotangent g of out and s = sum_d g * out per node and head:
//   zpre[i,j,h] = wd[i,h] + ws[j,h] + sum_r EA_r[i,j] * v[r,h] + c[h]
//   P[i,j,h]    = exp(leaky(zpre) - m[i,h]) / den[i,h]   where adj > 0, else 0
//   d_zpre      = P * (sum_d g[i,h,d] * nf[j,h,d] - s[i,h]) * (zpre > 0 ? 1 : slope)
// it emits
//   d_wd[i,h] = sum_j d_zpre,   d_ws[j,h] = sum_i d_zpre
//   d_nf[j,h,:] = sum_i P[i,j,h] * g[i,h,:]            (the P^T g aggregation)
//   d_vc_part[t, r, h] = sum_ij d_zpre * EA_r[i,j],  d_vc_part[t, R, h] = sum_ij d_zpre
// (per-tile partials; the wrapper sums them over tiles, as the JAX op sums
// its per-step partials, dense_gat.py:803-804). den == 0 counts as 1.
//
// What bounds it on this card: reading the planes, (R+1)*tn*tn*4 bytes per
// tile, as in the forward; the work per nonzero (one g[i]·nf[j] dot per head
// and one row of d_nf) is small because the molecular adjacency is sparse.
//
// Design: one block per tile, so the tile's column sums d_nf (tn x H*D f32:
// 64 KB at tn = 128, 128 KB at tn = 256) and d_ws stay in shared memory and
// are written once with plain stores; nothing leaves the SM as a partial but
// the (R+1) x H rank sums. The planes do not fit a block's 227 KB, so they
// are streamed as in the forward: a warp per destination row, each lane
// reading tn/32 columns of the adjacency and the R attribute rows once
// (coalesced) for all H heads, P recomputed from (m, den) in one pass. The
// row's nonzero columns are walked by warp ballot; for each, the per-head
// dot g[i]·nf[j] is a warp reduction with lanes along D, d_zpre is then
// known to every lane, d_wd accumulates in registers, d_ws and d_nf in
// shared memory by shared atomics, and lane r < R fetches EA_r[i,j] (lane R
// takes 1) to accumulate row r of the rank sums in a register. The TPU
// kernel's (8, .) paddings of wsT, vc and d_vc and its G-tiles-per-step loop
// are not carried over. Shared atomics make the summation order vary between
// runs (last-bit differences).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

template <int H, int JPL>  // JPL = tn / 32 columns per lane
__global__ void __launch_bounds__(kThreads, 1) dense_gat_bwd_kernel(
    const float* __restrict__ planes,  // (n_tiles, (R+1)*tn, tn)
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ vc,      // (R+1, H): rows v[0..R-1], then c
    const float* __restrict__ m,       // (N, H)
    const float* __restrict__ den,     // (N, H)
    const float* __restrict__ g,       // (N, H*D)
    const float* __restrict__ s_in,    // (N, H)
    float* __restrict__ d_wd,          // (N, H)
    float* __restrict__ d_ws,          // (N, H)
    float* __restrict__ d_nf,          // (N, H*D)
    float* __restrict__ d_vc,          // (n_tiles, R+1, H)
    int D, int R, float slope) {
  constexpr int tn = 32 * JPL;
  extern __shared__ float smem[];
  const int HD = H * D;
  float* dnf_s = smem;              // tn * HD
  float* ws_s = dnf_s + tn * HD;    // tn * H
  float* dws_s = ws_s + tn * H;     // tn * H
  float* vc_s = dws_s + tn * H;     // (R+1) * H
  float* dvc_s = vc_s + (R + 1) * H;  // (R+1) * H

  const int t = blockIdx.x;
  const int node0 = t * tn;
  const int tid = threadIdx.x;
  for (int i = tid; i < tn * HD; i += kThreads) dnf_s[i] = 0.f;
  for (int i = tid; i < tn * H; i += kThreads) {
    ws_s[i] = ws[(size_t)node0 * H + i];
    dws_s[i] = 0.f;
  }
  for (int i = tid; i < (R + 1) * H; i += kThreads) {
    vc_s[i] = vc[i];
    dvc_s[i] = 0.f;
  }
  __syncthreads();

  const size_t plane = (size_t)tn * tn;
  const float* tile = planes + (size_t)t * (R + 1) * plane;
  const int lane = tid & 31, warp = tid >> 5;
  float vacc[H];  // lane r <= R: row r of this warp's rank sums
#pragma unroll
  for (int h = 0; h < H; ++h) vacc[h] = 0.f;

  for (int i = warp; i < tn; i += kThreads / 32) {
    const int node = node0 + i;
    float mi[H], dgi[H], si[H], z[JPL][H], pf[JPL][H], adj[JPL];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      mi[h] = m[(size_t)node * H + h];
      const float dn = den[(size_t)node * H + h];
      dgi[h] = dn == 0.f ? 1.f : dn;
      si[h] = s_in[(size_t)node * H + h];
    }
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      const int j = lane + 32 * k;
      adj[k] = tile[(size_t)i * tn + j];
#pragma unroll
      for (int h = 0; h < H; ++h)
        z[k][h] = wd[(size_t)node * H + h] + ws_s[j * H + h];
    }
    for (int r = 0; r < R; ++r) {
      const float* row = tile + (size_t)(r + 1) * plane + (size_t)i * tn;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        const float ea = row[lane + 32 * k];
#pragma unroll
        for (int h = 0; h < H; ++h) z[k][h] += ea * vc_s[r * H + h];
      }
    }
    // z becomes P; pf = P * leaky'(zpre)
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float zp = z[k][h] + vc_s[R * H + h];
        float p = 0.f;
        if (adj[k] > 0.f) p = expf(leaky(zp, slope) - mi[h]) / dgi[h];
        z[k][h] = p;
        pf[k][h] = p * (zp > 0.f ? 1.f : slope);
      }
    }

    float dwd[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dwd[h] = 0.f;
    const float* grow = g + (size_t)node * HD;
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      unsigned nz = __ballot_sync(kFull, adj[k] > 0.f);
      while (nz) {
        const int b = __ffs(nz) - 1;
        nz &= nz - 1;
        const int j = 32 * k + b;
        const float ea = lane < R
            ? tile[(size_t)(lane + 1) * plane + (size_t)i * tn + j] : 1.f;
        const float* nrow = nf + (size_t)(node0 + j) * HD;
        float* drow = dnf_s + j * HD;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float pj = __shfl_sync(kFull, z[k][h], b);
          const float pfj = __shfl_sync(kFull, pf[k][h], b);
          float dp = 0.f;
          for (int d = lane; d < D; d += 32) {
            const float gv = grow[h * D + d];
            dp += gv * nrow[h * D + d];
            atomicAdd(&drow[h * D + d], pj * gv);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dp += __shfl_xor_sync(kFull, dp, o);
          const float dz = pfj * (dp - si[h]);
          dwd[h] += dz;
          vacc[h] += dz * ea;
          if (lane == 0) atomicAdd(&dws_s[j * H + h], dz);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
      if (lane == h) d_wd[(size_t)node * H + h] = dwd[h];
  }

  if (lane <= R) {
#pragma unroll
    for (int h = 0; h < H; ++h) atomicAdd(&dvc_s[lane * H + h], vacc[h]);
  }
  __syncthreads();
  for (int i = tid; i < tn * HD; i += kThreads)
    d_nf[(size_t)node0 * HD + i] = dnf_s[i];
  for (int i = tid; i < tn * H; i += kThreads)
    d_ws[(size_t)node0 * H + i] = dws_s[i];
  for (int i = tid; i < (R + 1) * H; i += kThreads)
    d_vc[(size_t)t * (R + 1) * H + i] = dvc_s[i];
}

template <int H, int JPL>
int launch(const float* planes, const float* wd, const float* ws,
           const float* nf, const float* vc, const float* m,
           const float* den, const float* g, const float* s, float* d_wd,
           float* d_ws, float* d_nf, float* d_vc, int n_tiles, int D, int R,
           float slope, cudaStream_t stream) {
  constexpr int tn = 32 * JPL;
  const size_t smem = sizeof(float) * ((size_t)tn * H * D + 2 * (size_t)tn * H
                                       + 2 * (size_t)(R + 1) * H);
  cudaError_t err = cudaFuncSetAttribute(
      dense_gat_bwd_kernel<H, JPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_gat_bwd_kernel<H, JPL><<<n_tiles, kThreads, smem, stream>>>(
      planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, D, R,
      slope);
  return (int)cudaGetLastError();
}

template <int H>
int launch_tn(int tn, const float* planes, const float* wd, const float* ws,
              const float* nf, const float* vc, const float* m,
              const float* den, const float* g, const float* s, float* d_wd,
              float* d_ws, float* d_nf, float* d_vc, int n_tiles, int D,
              int R, float slope, cudaStream_t st) {
  switch (tn) {
    case 32: return launch<H, 1>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 64: return launch<H, 2>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 128: return launch<H, 4>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 256: return launch<H, 8>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_gat_bwd(
    const void* planes, const void* wd, const void* ws, const void* nf,
    const void* vc, const void* m, const void* den, const void* g,
    const void* s, void* d_wd, void* d_ws, void* d_nf, void* d_vc,
    int n_tiles, int tn, int H, int D, int R, float slope, void* stream) {
  if (R < 0 || R + 1 > 32) return (int)cudaErrorInvalidValue;
  const float* a[9] = {(const float*)planes, (const float*)wd,
                       (const float*)ws, (const float*)nf, (const float*)vc,
                       (const float*)m, (const float*)den, (const float*)g,
                       (const float*)s};
  float* o[4] = {(float*)d_wd, (float*)d_ws, (float*)d_nf, (float*)d_vc};
  cudaStream_t st = (cudaStream_t)stream;
  switch (H) {
    case 1: return launch_tn<1>(tn, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1], o[2], o[3], n_tiles, D, R, slope, st);
    case 2: return launch_tn<2>(tn, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1], o[2], o[3], n_tiles, D, R, slope, st);
    case 4: return launch_tn<4>(tn, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1], o[2], o[3], n_tiles, D, R, slope, st);
    case 8: return launch_tn<8>(tn, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1], o[2], o[3], n_tiles, D, R, slope, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_gat_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
