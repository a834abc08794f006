// Dense-attr GAT forward pass (atom, frag and fconn levels under the
// dense-attr kernel policy), for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_attr_fwd_kernel
// (l.216), built by _build_attr (l.476, pallas_call l.497) and entered
// through dense_attr_gat_pass (l.632). Same function: for tile t of tn
// nodes, row i = destination, column j = source, with W_h[i, j] = w_ea[e, h]
// of the counted edge e at local slot (i, j) (e inside the tile's TCSR edge
// window [ew_blk[t]*te, (ew_blk[t]+cw[t])*te), emask[e] > 0, both ends in
// tile t) and 0 where there is none,
//   zpre = wd[i,h] + ws[j,h] + W_h[i,j];  z = leaky(zpre) where adj > 0, else -1e30
//   m = max_j z   (with self_loops: m = max(m, leaky(wd[i,h] + ws[i,h])))
//   p = exp(z - m) * adj;  den = sum_j p   (+ ps = exp(zs - m) with self_loops)
//   out[i, h*D:(h+1)*D] = (sum_j p * nf[j] + ps * nf[i]) / (den, or 1 where 0)
// emitting out (N, H*D), m and den (N, H). Self-loops are folded into every
// row of the tile, padding included, as the TPU kernel folds them.
//
// What bounds it on this card: reading the adjacency plane (tn*tn*4 bytes
// per tile) and, for each of the few nonzeros per row, one nf row (H*D f32)
// and the edge's H logit terms; a few flops per byte, so bytes, and at the
// batch sizes of training (2-6 tiles a level) latency.
//
// Design: the TPU kernel scatters each te-edge chunk of w_ea into H dense
// (tn, tn) planes with one-hot matmuls, because Mosaic has no cheap indexed
// load. Four such planes are 256 KiB at tn = 128, more than a block's 227 KB
// of shared memory, and one is 256 KiB at tn = 256. Here no W plane exists:
// a block takes one (tile, group of kRows destination rows), scans the
// tile's edge window once and records in shared memory, for each slot of
// its rows, the id of the edge that lands there (kRows x tn int32: 16 KiB
// at tn = 128, 32 KiB at tn = 256, for any H). Then, as in dense_gat_fwd.cu,
// one warp per row, each lane owning tn/32 columns, reads the adjacency row
// once (coalesced) and looks up w_ea[e] for its slots that hold an edge;
// row max and sum are warp shuffles; the aggregation walks only the row's
// nonzero columns (warp ballot), lanes along D, reading nf rows from global
// memory (L2-resident at these sizes). The adjacency is addressed through
// its tile stride, so the fconn level's first tn rows of the R = 6 planes
// are read in place. kRows-row groups give tn/32 blocks per tile. At most
// one counted edge per slot is assumed (packing.dp_level_ok; the host
// builder refuses repeated pairs).

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
__global__ void __launch_bounds__(kThreads) dense_attr_fwd_kernel(
    const float* __restrict__ adj,     // (n_tiles, tn, tn), tile stride adj_stride
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ w_ea,    // (E, H)
    const int32_t* __restrict__ src,   // (E,)
    const int32_t* __restrict__ dst,   // (E,)
    const float* __restrict__ emask,   // (E,)
    const int32_t* __restrict__ ew_blk,  // (n_tiles,) window start, te blocks
    const int32_t* __restrict__ cw,      // (n_tiles,) window width, te blocks
    float* __restrict__ out,           // (N, H*D)
    float* __restrict__ m_out,         // (N, H)
    float* __restrict__ den_out,       // (N, H)
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
    float wdi[H];
#pragma unroll
    for (int h = 0; h < H; ++h) wdi[h] = wd[(size_t)node * H + h];

    float a[JPL];
    float z[JPL][H];
#pragma unroll
    for (int k = 0; k < JPL; ++k) {
      const int j = lane + 32 * k;
      a[k] = tile[(size_t)i * tn + j];
      const int e = slot[r * tn + j];
#pragma unroll
      for (int h = 0; h < H; ++h)
        z[k][h] = wdi[h] + ws_s[j * H + h]
                  + (e >= 0 ? w_ea[(size_t)e * H + h] : 0.f);
    }
    float mh[H], dh[H], ps[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        z[k][h] = a[k] > 0.f ? leaky(z[k][h], slope) : kNeg;
        mx = fmaxf(mx, z[k][h]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float zs = leaky(wdi[h] + ws_s[i * H + h], slope);
      if (self_loops) mx = fmaxf(mx, zs);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        z[k][h] = a[k] > 0.f ? expf(z[k][h] - mx) * a[k] : 0.f;  // p
        sum += z[k][h];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      ps[h] = self_loops ? expf(zs - mx) : 0.f;
      mh[h] = mx;
      dh[h] = sum + ps[h];
    }

    const float* own = nf + (size_t)node * HD;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      const bool dv = d < D;
      float acc[H];
#pragma unroll
      for (int h = 0; h < H; ++h)
        acc[h] = (self_loops && dv) ? ps[h] * own[h * D + d] : 0.f;
#pragma unroll
      for (int k = 0; k < JPL; ++k) {
        unsigned nz = __ballot_sync(kFull, a[k] > 0.f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          const float* nrow = nf + (size_t)(node0 + 32 * k + b) * HD;
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

struct Args {
  const float *adj, *wd, *ws, *nf, *w_ea;
  const int32_t *src, *dst;
  const float* emask;
  const int32_t *ew_blk, *cw;
  float *out, *m, *den;
  long long adj_stride;
  int n_tiles, E, te, D, self_loops;
  float slope;
};

template <int H, int JPL>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int tn = 32 * JPL;
  const size_t smem = sizeof(int32_t) * kRows * tn + sizeof(float) * tn * H;
  cudaError_t err = cudaFuncSetAttribute(
      dense_attr_fwd_kernel<H, JPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.n_tiles == 0) return 0;
  dim3 grid(a.n_tiles, tn / kRows);
  dense_attr_fwd_kernel<H, JPL><<<grid, kThreads, smem, stream>>>(
      a.adj, a.wd, a.ws, a.nf, a.w_ea, a.src, a.dst, a.emask, a.ew_blk, a.cw,
      a.out, a.m, a.den, a.adj_stride, a.E, a.te, a.D, a.self_loops,
      a.slope);
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

extern "C" int dense_attr_fwd(
    const void* adj, const void* wd, const void* ws, const void* nf,
    const void* w_ea, const void* src, const void* dst, const void* emask,
    const void* ew_blk, const void* cw, void* out, void* m, void* den,
    long long adj_stride, int n_tiles, int tn, int H, int D, int E, int te,
    int self_loops, float slope, void* stream) {
  Args a{(const float*)adj, (const float*)wd, (const float*)ws,
         (const float*)nf, (const float*)w_ea, (const int32_t*)src,
         (const int32_t*)dst, (const float*)emask, (const int32_t*)ew_blk,
         (const int32_t*)cw, (float*)out, (float*)m, (float*)den,
         adj_stride, n_tiles, E, te, D, self_loops, slope};
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 1: return launch_tn<1>(tn, a, s);
    case 2: return launch_tn<2>(tn, a, s);
    case 4: return launch_tn<4>(tn, a, s);
    case 8: return launch_tn<8>(tn, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_attr_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
