// Dense per-tile GAT forward pass over host-built planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_fwd_kernel (l.387),
// built by _build (l.704) and entered through dense_gat_pass (l.813). Same
// function: for tile t of tn nodes, with planes[t] = (adjacency, EA_1..EA_R)
// each (tn, tn), row i = destination, column j = source,
//   z[i,j,h] = leaky(wd[i,h] + ws[j,h] + sum_r EA_r[i,j] * v[r,h] + c[h])
//   masked to -1e30 where adj[i,j] == 0; m = max_j z; p = exp(z - m) * adj
//   den = sum_j p;  out[i, h*D:(h+1)*D] = sum_j p * nf[j, h*D:(h+1)*D] / den
// with den == 0 -> 1 in the division, emitting out (N, H*D), m and den (N, H).
//
// What bounds it on this card: reading the planes, (R+1)*tn*tn*4 bytes per
// tile (512 KiB for a bond tile at tn = 256, 448 KiB for an fconn tile at
// tn = 128), against a few flops per plane element; the adjacency is sparse
// (a molecule node has a handful of neighbours), so P*nf is small.
//
// Design: a tile's planes do not fit a block's 227 KB of shared memory, so
// they are streamed: one block per (tile, block of 32 destination rows), one
// warp per row; each lane reads tn/32 columns of the adjacency and of the R
// attribute rows once (coalesced) and computes all H heads from them, so a
// plane element is read once and not H times. Row max and sum are warp
// shuffles. The tile's nf (tn x H*D) and ws sit in shared memory; the
// aggregation walks only the row's nonzero columns (warp ballot) and
// broadcasts p by shuffle, lanes along D. The TPU kernel's (8, .) paddings
// of wsT and vc and its G-tiles-per-step loop are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kRows = 32;  // destination rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

template <int H, int JPL>  // JPL = tn / 32 columns per lane
__global__ void __launch_bounds__(kThreads) dense_gat_fwd_kernel(
    const float* __restrict__ planes,  // (n_tiles, (R+1)*tn, tn)
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ vc,      // (R+1, H): rows v[0..R-1], then c
    float* __restrict__ out,           // (N, H*D)
    float* __restrict__ m_out,         // (N, H)
    float* __restrict__ den_out,       // (N, H)
    int D, int R, float slope) {
  constexpr int tn = 32 * JPL;
  extern __shared__ float smem[];
  const int HD = H * D;
  float* nf_s = smem;              // tn * HD
  float* ws_s = nf_s + tn * HD;    // tn * H
  float* vc_s = ws_s + tn * H;     // (R+1) * H

  const int t = blockIdx.x;
  const int node0 = t * tn;
  const int tid = threadIdx.x;
  for (int i = tid; i < tn * HD; i += kThreads)
    nf_s[i] = nf[(size_t)node0 * HD + i];
  for (int i = tid; i < tn * H; i += kThreads)
    ws_s[i] = ws[(size_t)node0 * H + i];
  for (int i = tid; i < (R + 1) * H; i += kThreads) vc_s[i] = vc[i];
  __syncthreads();

  const size_t plane = (size_t)tn * tn;
  const float* tile = planes + (size_t)t * (R + 1) * plane;
  const int lane = tid & 31, warp = tid >> 5;
  const int row_end = min(((int)blockIdx.y + 1) * kRows, tn);
  for (int i = blockIdx.y * kRows + warp; i < row_end; i += kThreads / 32) {
    const int node = node0 + i;
    float wdi[H];
#pragma unroll
    for (int h = 0; h < H; ++h) wdi[h] = wd[(size_t)node * H + h];

    float adj[JPL];
    float z[JPL][H];
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      const int j = lane + 32 * k;
      adj[k] = tile[(size_t)i * tn + j];
#pragma unroll
      for (int h = 0; h < H; ++h) z[k][h] = wdi[h] + ws_s[j * H + h];
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
    float mh[H], dh[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        const float zz = leaky(z[k][h] + vc_s[R * H + h], slope);
        z[k][h] = adj[k] > 0.f ? zz : kNeg;
        mx = fmaxf(mx, z[k][h]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        z[k][h] = adj[k] > 0.f ? expf(z[k][h] - mx) * adj[k] : 0.f;  // p
        sum += z[k][h];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      mh[h] = mx;
      dh[h] = sum;
    }

    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      const bool dv = d < D;
      float acc[H];
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = 0.f;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        unsigned nz = __ballot_sync(kFull, adj[k] > 0.f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float* nrow = nf_s + (32 * k + b) * HD;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float pj = __shfl_sync(kFull, z[k][h], b);
            if (dv) acc[h] += pj * nrow[h * D + d];
          }
        }
      }
      if (dv) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          out[(size_t)node * HD + h * D + d] =
              acc[h] / (dh[h] == 0.f ? 1.f : dh[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (lane == h) {
        m_out[(size_t)node * H + h] = mh[h];
        den_out[(size_t)node * H + h] = dh[h];
      }
    }
  }
}

template <int H, int JPL>
int launch(const float* planes, const float* wd, const float* ws,
           const float* nf, const float* vc, float* out, float* m,
           float* den, int n_tiles, int D, int R, float slope,
           cudaStream_t stream) {
  constexpr int tn = 32 * JPL;
  const size_t smem =
      sizeof(float) * ((size_t)tn * H * D + (size_t)tn * H + (R + 1) * H);
  cudaError_t err = cudaFuncSetAttribute(
      dense_gat_fwd_kernel<H, JPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, (tn + kRows - 1) / kRows);
  dense_gat_fwd_kernel<H, JPL><<<grid, kThreads, smem, stream>>>(
      planes, wd, ws, nf, vc, out, m, den, D, R, slope);
  return (int)cudaGetLastError();
}

template <int H>
int launch_tn(int tn, const float* planes, const float* wd, const float* ws,
              const float* nf, const float* vc, float* out, float* m,
              float* den, int n_tiles, int D, int R, float slope,
              cudaStream_t s) {
  switch (tn) {
    case 32: return launch<H, 1>(planes, wd, ws, nf, vc, out, m, den, n_tiles, D, R, slope, s);
    case 64: return launch<H, 2>(planes, wd, ws, nf, vc, out, m, den, n_tiles, D, R, slope, s);
    case 128: return launch<H, 4>(planes, wd, ws, nf, vc, out, m, den, n_tiles, D, R, slope, s);
    case 256: return launch<H, 8>(planes, wd, ws, nf, vc, out, m, den, n_tiles, D, R, slope, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_gat_fwd(
    const void* planes, const void* wd, const void* ws, const void* nf,
    const void* vc, void* out, void* m, void* den, int n_tiles, int tn,
    int H, int D, int R, float slope, void* stream) {
  const float* p = (const float*)planes;
  const float* a = (const float*)wd;
  const float* b = (const float*)ws;
  const float* x = (const float*)nf;
  const float* v = (const float*)vc;
  float* o = (float*)out;
  float* mm = (float*)m;
  float* dd = (float*)den;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 1: return launch_tn<1>(tn, p, a, b, x, v, o, mm, dd, n_tiles, D, R, slope, s);
    case 2: return launch_tn<2>(tn, p, a, b, x, v, o, mm, dd, n_tiles, D, R, slope, s);
    case 4: return launch_tn<4>(tn, p, a, b, x, v, o, mm, dd, n_tiles, D, R, slope, s);
    case 8: return launch_tn<8>(tn, p, a, b, x, v, o, mm, dd, n_tiles, D, R, slope, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_gat_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
