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
// What bounds it on this card: the bytes are the planes, (R+1)*tn*tn*4 per
// tile, of which only the adjacency rows and the nonzeros' attribute values
// need reading, plus a few node rows; the work per nonzero (one g[i]·nf[j]
// dot per head and one row of d_nf) is small because the molecular
// adjacency is sparse (2-4 nonzeros per bond-graph row). So at the sizes of
// the training paths the kernel is bound by latency: how many SMs have work
// and how long each warp's chain of dependent loads is. The first port (a
// block per tile: 12 blocks at the finetune bond level, 2 at fconn; per
// nonzero a loop over heads, each with global reloads, a shuffle reduction
// and shared atomics) ran at 1-2% of its byte bound.
//
// Design: one launch, two roles, no atomics. A tile's rows are cut into
// slices of 16 (32 at tn = 256), 8 per tile (fewer at tn < 128), and its
// columns likewise; a block of 8 warps takes one slice in one role, a warp
// one row (column) at a time.
//   * Row role: lanes along H*D with float4 loads (a lane's four columns lie
//     in one head), so g[i] and the row's scalars sit in registers. The warp
//     reads the adjacency row (coalesced), lists its nonzero columns by
//     ballot, and issues kUnroll nonzeros' nf[j], ws[j] and EA_r[i,j] loads
//     before folding any in. The per-head dot g[i]·nf[j] is a segmented
//     shuffle reduction over the D/4 lanes of a head, all heads at once. It
//     emits d_wd and the d_vc partial (lane r <= R holds row r).
//   * Column role: a warp per column j with nf[j] in registers; it reads
//     column j of the adjacency (one strided load per 32 rows, all in
//     flight), lists its nonzero rows and recomputes P and d_zpre for each
//     pair from (m, den, s, wd, ws, vc) and the planes, which sit in L2. It
//     emits d_nf[j] and d_ws[j].
//   So every output is written once by one warp: the column sums need no
//   atomics and no zero fills, and the result is the same from run to run
//   (global float atomics would save the column role's recomputation but
//   need zero-filled outputs and give run-to-run differences). The d_vc
//   partials of a tile's row slices are summed across blocks through a
//   thread block cluster: the row slices of one tile form a cluster, each
//   block reduces its warps' partials in shared memory in a fixed order,
//   and the cluster's first block adds the others' through distributed
//   shared memory, in rank order, and writes the tile's row.
// What bounds the design now (measured on the H100; PERF.md): at the
// finetune batch each warp's chain of two rows of dependent loads and
// per-nonzero shuffles; at the pretraining batch (250 tiles) the
// instructions per nonzero, of which the per-head scalars (logit, exp,
// division) repeat in every lane of the head, and the cluster's placement.
// The TPU kernel's (8, .) paddings of wsT, vc and d_vc and its G-tiles-per-
// step loop are not carried over, nor its dense (tn x tn) per-head matmuls:
// the adjacency is sparse, and TF32 products would not keep the 1e-4
// agreement.
//
// dense_gat_bwd_bf16 is the same kernel with nf in bf16 (the JAX package's
// bf16 compute, dense_gat.py:_build's dt_name, l.704-706): both roles read
// nf rows as a lane's four columns in one 8-byte load, widened to f32
// exactly; g, s, m, den, the planes and every output stay f32
// (dense_gat.py:790 casts g to f32; s comes from the forward's f32 out),
// so a one-neighbour row still cancels exactly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

typedef unsigned short bf16_bits;  // one bf16 value, as stored

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // nonzeros whose loads a warp has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four adjacent bf16 columns as one 8-byte load, widened to f32 exactly (a
// bf16 is the high half of its f32)
__device__ __forceinline__ float4 ld4(const bf16_bits* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The per-head dot g[i]·nf[j] is summed in one fixed order, the order in
// which the wrapper sums s = sum_d g·out (ops/dense_gat.py:head_dot):
// rounded products, pairwise within a lane's four columns, then halves
// across the head's lanes. Where a row's output equals a neighbour's
// features, dp - s is then exactly 0, as the math says.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fadd_rn(__fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w)));
}

// sum over the w lanes of a head (w a power of two, segments aligned)
__device__ __forceinline__ float head_sum(float x, int w) {
  for (int o = w >> 1; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Lists the set bits of the warp's JPL ballots (ascending index) into the
// warp's shared list; returns the count (the same in every lane).
template <int JPL>
__device__ __forceinline__ int list_nonzeros(const float (&a)[JPL],
                                             int* list, int lane) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < JPL; ++k) {
    const unsigned b = __ballot_sync(kFull, a[k] > 0.f);
    if (a[k] > 0.f) list[n + __popc(b & ((1u << lane) - 1u))] = 32 * k + lane;
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// tn = 32 * JPL; H*D <= 128 * NV; T: nf's element type
template <int H, int JPL, int NV, typename T>
__global__ void __launch_bounds__(kThreads) dense_gat_bwd_kernel(
    const float* __restrict__ planes,  // (n_tiles, (R+1)*tn, tn)
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const T* __restrict__ nf,          // (N, H*D), f32 or bf16
    const float* __restrict__ vc,      // (R+1, H): rows v[0..R-1], then c
    const float* __restrict__ m,       // (N, H)
    const float* __restrict__ den,     // (N, H)
    const float* __restrict__ g,       // (N, H*D)
    const float* __restrict__ s_in,    // (N, H)
    float* __restrict__ d_wd,          // (N, H)
    float* __restrict__ d_ws,          // (N, H)
    float* __restrict__ d_nf,          // (N, H*D)
    float* __restrict__ d_vc,          // (n_tiles, R+1, H)
    int D, int R, float slope, int n_slices) {
  constexpr int tn = 32 * JPL;
  __shared__ float vc_s[32 * H];            // (R+1) x H
  __shared__ int lists[kWarps][tn];         // a warp's nonzero columns/rows
  __shared__ float red[kWarps][32 * H];     // the warps' d_vc partials
  __shared__ float part[32 * H];            // the block's d_vc partial

  const int HD = H * D;
  const int t = blockIdx.y;
  const bool col_role = blockIdx.x >= n_slices;
  const int slice = col_role ? blockIdx.x - n_slices : blockIdx.x;
  const int rs = tn / n_slices;  // rows (or columns) per slice
  const int node0 = t * tn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = D >> 2;          // lanes per head
  const size_t plane = (size_t)tn * tn;
  const float* tile = planes + (size_t)t * (R + 1) * plane;
  int* list = lists[warp];
  for (int i = tid; i < (R + 1) * H; i += kThreads) vc_s[i] = vc[i];
  __syncthreads();

  int col[NV], hd[NV];
  bool on[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / D : 0;
  }
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  if (!col_role) {
    // ---- row role: d_wd and the d_vc partial ----------------------------
    float vacc[H];  // lane r <= R: row r of this warp's d_vc partial
#pragma unroll
    for (int h = 0; h < H; ++h) vacc[h] = 0.f;
    for (int ii = warp; ii < rs; ii += kWarps) {
      const int i = slice * rs + ii;
      const size_t node = (size_t)node0 + i;
      float a[JPL];
#pragma unroll
      for (int k = 0; k < JPL; ++k) a[k] = tile[(size_t)i * tn + lane + 32 * k];
      float4 gi[NV];
      float mi[NV], dgi[NV], si[NV], wdi[NV], dwd[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        gi[v] = on[v] ? ld4(g + node * HD + col[v]) : zero4;
        mi[v] = m[node * H + hd[v]];
        const float dn = den[node * H + hd[v]];
        dgi[v] = dn == 0.f ? 1.f : dn;
        si[v] = s_in[node * H + hd[v]];
        wdi[v] = wd[node * H + hd[v]];
        dwd[v] = 0.f;
      }
      const int n = list_nonzeros<JPL>(a, list, lane);
      for (int b0 = 0; b0 < n; b0 += kUnroll) {
        int js[kUnroll];
        float4 x[kUnroll][NV];
        float wsj[kUnroll][NV], ea[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool ok = b0 + u < n;
          js[u] = ok ? list[b0 + u] : 0;
          const size_t nj = (size_t)node0 + js[u];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            x[u][v] = ok && on[v] ? ld4(nf + nj * HD + col[v]) : zero4;
            wsj[u][v] = ws[nj * H + hd[v]];
          }
          ea[u] = ok && lane < R
              ? tile[(size_t)(lane + 1) * plane + (size_t)i * tn + js[u]]
              : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (b0 + u >= n) break;  // warp-uniform
          float dz[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float zp = wdi[v] + wsj[u][v] + vc_s[R * H + hd[v]];
            for (int r = 0; r < R; ++r)
              zp += __shfl_sync(kFull, ea[u], r) * vc_s[r * H + hd[v]];
            const float p = expf(leaky(zp, slope) - mi[v]) / dgi[v];
            const float dp = head_sum(dot4(gi[v], x[u][v]), W);
            dz[v] = p * (dp - si[v]) * (zp > 0.f ? 1.f : slope);
            dwd[v] += dz[v];
          }
          const float eav = lane < R ? ea[u] : 1.f;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int c = h * D;  // the head's first column
            const float dzh = __shfl_sync(
                kFull, NV == 1 || c < 128 ? dz[0] : dz[NV - 1], (c & 127) >> 2);
            vacc[h] += dzh * eav;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (on[v] && col[v] % D == 0) d_wd[node * H + hd[v]] = dwd[v];
    }

    // the block's partial in a fixed order, then the cluster's in rank order
    if (lane <= R) {
#pragma unroll
      for (int h = 0; h < H; ++h) red[warp][lane * H + h] = vacc[h];
    }
    __syncthreads();
    for (int q = tid; q < (R + 1) * H; q += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[w][q];
      part[q] = sum;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int q = tid; q < (R + 1) * H; q += kThreads) {
        float sum = 0.f;
        for (int b = 0; b < n_slices; ++b)
          sum += cluster.map_shared_rank(part, b)[q];
        d_vc[(size_t)t * (R + 1) * H + q] = sum;
      }
    }
    cluster.sync();  // the others' shared memory lives until it is read
    return;
  }

  // ---- column role: d_nf and d_ws -----------------------------------------
  for (int jj = warp; jj < rs; jj += kWarps) {
    const int j = slice * rs + jj;
    const size_t nj = (size_t)node0 + j;
    float a[JPL];
#pragma unroll
    for (int k = 0; k < JPL; ++k) a[k] = tile[(size_t)(lane + 32 * k) * tn + j];
    float4 xj[NV], dnf[NV];
    float wsj[NV], dws[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xj[v] = on[v] ? ld4(nf + nj * HD + col[v]) : zero4;
      wsj[v] = ws[nj * H + hd[v]] + vc_s[R * H + hd[v]];
      dnf[v] = zero4;
      dws[v] = 0.f;
    }
    const int n = list_nonzeros<JPL>(a, list, lane);
    for (int b0 = 0; b0 < n; b0 += kUnroll) {
      float4 gu[kUnroll][NV];
      float wdu[kUnroll][NV], mu[kUnroll][NV], dgu[kUnroll][NV],
          su[kUnroll][NV], ea[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = b0 + u < n;
        const int i = ok ? list[b0 + u] : 0;
        const size_t ni = (size_t)node0 + i;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          gu[u][v] = ok && on[v] ? ld4(g + ni * HD + col[v]) : zero4;
          wdu[u][v] = wd[ni * H + hd[v]];
          mu[u][v] = m[ni * H + hd[v]];
          dgu[u][v] = den[ni * H + hd[v]];
          su[u][v] = s_in[ni * H + hd[v]];
        }
        ea[u] = ok && lane < R
            ? tile[(size_t)(lane + 1) * plane + (size_t)i * tn + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u >= n) break;  // warp-uniform
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float zp = wdu[u][v] + wsj[v];
          for (int r = 0; r < R; ++r)
            zp += __shfl_sync(kFull, ea[u], r) * vc_s[r * H + hd[v]];
          const float dg = dgu[u][v] == 0.f ? 1.f : dgu[u][v];
          const float p = expf(leaky(zp, slope) - mu[u][v]) / dg;
          const float dp = head_sum(dot4(gu[u][v], xj[v]), W);
          dws[v] += p * (dp - su[u][v]) * (zp > 0.f ? 1.f : slope);
          dnf[v].x += p * gu[u][v].x;
          dnf[v].y += p * gu[u][v].y;
          dnf[v].z += p * gu[u][v].z;
          dnf[v].w += p * gu[u][v].w;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!on[v]) continue;
      *reinterpret_cast<float4*>(d_nf + nj * HD + col[v]) = dnf[v];
      if (col[v] % D == 0) d_ws[nj * H + hd[v]] = dws[v];
    }
  }
}

template <int H, int JPL, int NV, typename T>
int launch(const float* planes, const float* wd, const float* ws,
           const T* nf, const float* vc, const float* m,
           const float* den, const float* g, const float* s, float* d_wd,
           float* d_ws, float* d_nf, float* d_vc, int n_tiles, int D, int R,
           float slope, cudaStream_t stream) {
  // row slices of 16 rows (32 at tn = 256); a tile's slices form a cluster
  constexpr int n_slices = JPL >= 4 ? 8 : 2 * JPL;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * n_slices, n_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_gat_bwd_kernel<H, JPL, NV, T>, planes, wd, ws, nf, vc, m, den,
      g, s, d_wd, d_ws, d_nf, d_vc, D, R, slope, n_slices);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int H, int NV, typename T>
int launch_tn(int tn, const float* planes, const float* wd, const float* ws,
              const T* nf, const float* vc, const float* m,
              const float* den, const float* g, const float* s, float* d_wd,
              float* d_ws, float* d_nf, float* d_vc, int n_tiles, int D,
              int R, float slope, cudaStream_t st) {
  switch (tn) {
    case 32: return launch<H, 1, NV, T>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 64: return launch<H, 2, NV, T>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 128: return launch<H, 4, NV, T>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
    case 256: return launch<H, 8, NV, T>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws, d_nf, d_vc, n_tiles, D, R, slope, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_h(const void* planes, const void* wd, const void* ws,
             const void* nf, const void* vc, const void* m, const void* den,
             const void* g, const void* s, void* d_wd, void* d_ws,
             void* d_nf, void* d_vc, int n_tiles, int tn, int H, int D,
             int R, float slope, void* stream) {
  // D/4 lanes per head, a power of two up to 32; H*D <= 256
  const int w = D / 4;
  if (R < 0 || R + 1 > 32 || D % 4 || w < 1 || w > 32 || (w & (w - 1))
      || H * D > 256)
    return (int)cudaErrorInvalidValue;
  const float* a[8] = {(const float*)planes, (const float*)wd,
                       (const float*)ws, (const float*)vc, (const float*)m,
                       (const float*)den, (const float*)g, (const float*)s};
  const T* x = (const T*)nf;
  float* o[4] = {(float*)d_wd, (float*)d_ws, (float*)d_nf, (float*)d_vc};
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = H * D > 128;
#define DGB_ARGS tn, a[0], a[1], a[2], x, a[3], a[4], a[5], a[6], a[7], \
    o[0], o[1], o[2], o[3], n_tiles, D, R, slope, st
  switch (H) {
    case 1: return launch_tn<1, 1, T>(DGB_ARGS);
    case 2: return wide ? launch_tn<2, 2, T>(DGB_ARGS)
                        : launch_tn<2, 1, T>(DGB_ARGS);
    case 4: return wide ? launch_tn<4, 2, T>(DGB_ARGS)
                        : launch_tn<4, 1, T>(DGB_ARGS);
    case 8: return wide ? launch_tn<8, 2, T>(DGB_ARGS)
                        : launch_tn<8, 1, T>(DGB_ARGS);
  }
#undef DGB_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_gat_bwd(
    const void* planes, const void* wd, const void* ws, const void* nf,
    const void* vc, const void* m, const void* den, const void* g,
    const void* s, void* d_wd, void* d_ws, void* d_nf, void* d_vc,
    int n_tiles, int tn, int H, int D, int R, float slope, void* stream) {
  return launch_h<float>(planes, wd, ws, nf, vc, m, den, g, s, d_wd, d_ws,
                         d_nf, d_vc, n_tiles, tn, H, D, R, slope, stream);
}

// nf in bf16 (8-byte aligned rows); every other argument as above
extern "C" int dense_gat_bwd_bf16(
    const void* planes, const void* wd, const void* ws, const void* nf,
    const void* vc, const void* m, const void* den, const void* g,
    const void* s, void* d_wd, void* d_ws, void* d_nf, void* d_vc,
    int n_tiles, int tn, int H, int D, int R, float slope, void* stream) {
  return launch_h<bf16_bits>(planes, wd, ws, nf, vc, m, den, g, s, d_wd,
                             d_ws, d_nf, d_vc, n_tiles, tn, H, D, R, slope,
                             stream);
}

extern "C" const char* dense_gat_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dense_gat_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
