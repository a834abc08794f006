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
// per edge) and the per-edge scalars; the arithmetic is a few flops per
// byte. At the batch sizes of the eval path the grid is a handful of tiles,
// so launch latency and the serial walk of each window dominate.
//
// Design: the TPU kernel's one-hot matmul gathers/scatters, the _hsum/_hrep
// head broadcasts and the k_src source windows exist because Mosaic has no
// cheap indexed load; here nf[src] is read with direct indexed loads, lanes
// along H*D, so a source row is coalesced 128-byte reads. One block per
// destination tile keeps the tile's numerator (tn x H*D), max and
// denominator in shared memory (64 KB at tn = 128, 128 KB at tn = 256), so
// no partial sum leaves the SM. Instead of the TPU kernel's online
// rescaling over chunks, the block makes two passes over the real window:
// the max (one thread per edge, shared-memory CAS max), then rounds of 512
// edges in which one thread per edge stages p = exp(z - m) for every head
// in shared memory and adds it to den, and each warp aggregates four staged
// edges at a time, issuing all their nf[src] loads before the shared
// atomics (so a warp waits on one round of loads per four edges, not one
// per edge). The shared-memory float atomics make the summation order vary
// between runs (last-bit differences, well inside the 1e-4 relative check
// against the plain version).
//
// tcsr_gat_ep_fwd (K3's forward) is the same kernel on one edge shard of
// the edge-partitioned pass. It replaces the TPU kernel built by
// fragnet_tpu/ops/pallas_gat.py:_make_ep_op (l.635) — _fwd_kernel at
// n_tiles_grid = Tg, reading the absolute tile t0 + t (l.116) — and entered
// through pallas_gat_pass_ep (l.750). The grid is the shard's Tg tiles
// starting at tile t0 (read from device memory, so the caller never waits
// for it); the edge arrays and the windows ew_blk / cw are the shard's,
// node arrays stay whole, and row i of out, m, den holds absolute node
// t0 * tn + i. No self-loops: the combine adds them once. What bounds it is
// what bounds the whole-batch kernel, on 1/S of the edges; the grid is
// smaller still, so launch latency weighs more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;    // staged edges per warp step
constexpr int kMaxCols = 8;   // H*D <= 256: columns per lane

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a;
  while (__int_as_float(old) < v) {
    const int assumed = old;
    old = atomicCAS(a, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__global__ void __launch_bounds__(kThreads, 1) tcsr_gat_fwd_kernel(
    const float* __restrict__ wn,      // (N, 2H): [w_dst | w_src]
    const float* __restrict__ nf,      // (N, H*D)
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
  extern __shared__ float smem[];
  const int HD = H * D;
  float* num = smem;                       // tn * HD
  float* m = num + tn * HD;                // tn * H
  float* den = m + tn * H;                 // tn * H
  float* st_p = den + tn * H;              // kThreads * H: staged p
  int* st_dl = reinterpret_cast<int*>(st_p + kThreads * H);  // kThreads
  int* st_src = st_dl + kThreads;                            // kThreads

  const int t = blockIdx.x;
  const int node0 = ((t0 ? t0[0] : 0) + t) * tn;  // absolute first node
  const size_t row0 = (size_t)t * tn;             // its output row
  const int e_lo = ew_blk[t] * te;
  const int e_hi = e_lo + cw[t] * te;
  const int tid = threadIdx.x;

  // 1. running max starts at the self-loop logit (or the empty marker)
  for (int i = tid; i < tn * H; i += kThreads) {
    const int n = i / H, h = i - n * H;
    const float* w = wn + (size_t)(node0 + n) * 2 * H;
    m[i] = self_loops ? leaky(w[h] + w[H + h], slope) : kNeg;
  }
  __syncthreads();

  // 2. max over the tile's edges in its real window, one thread per edge
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    const int d = dst[e];
    const int dl = d - node0;
    if (dl < 0 || dl >= tn || !(emask[e] > 0.f)) continue;
    const float* wd = wn + (size_t)d * 2 * H;
    const float* ws = wn + (size_t)src[e] * 2 * H + H;
    const float* wa = w_ea + (size_t)e * H;
    for (int h = 0; h < H; ++h)
      atomic_max_f32(&m[dl * H + h], leaky(wd[h] + ws[h] + wa[h], slope));
  }
  __syncthreads();

  // 3. the self-loop term at the final max seeds den and num
  for (int i = tid; i < tn * H; i += kThreads) {
    float p = 0.f;
    if (self_loops) {
      const int n = i / H, h = i - n * H;
      const float* w = wn + (size_t)(node0 + n) * 2 * H;
      p = expf(leaky(w[h] + w[H + h], slope) - m[i]);
    }
    den[i] = p;
  }
  __syncthreads();
  for (int i = tid; i < tn * HD; i += kThreads) {
    const int n = i / HD, c = i - n * HD;
    num[i] = self_loops
        ? den[n * H + c / D] * nf[(size_t)(node0 + n) * HD + c] : 0.f;
  }
  __syncthreads();

  // 4. rounds of kThreads edges: stage p (thread per edge), then aggregate
  //    kUnroll staged edges per warp step, all nf loads before the atomics
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = e_lo; base < e_hi; base += kThreads) {
    const int e = base + tid;
    int dl = -1;
    if (e < e_hi) {
      const int d = dst[e];
      dl = d - node0;
      if (dl < 0 || dl >= tn || !(emask[e] > 0.f)) {
        dl = -1;
      } else {
        const int s = src[e];
        const float* wd = wn + (size_t)d * 2 * H;
        const float* ws = wn + (size_t)s * 2 * H + H;
        const float* wa = w_ea + (size_t)e * H;
        for (int h = 0; h < H; ++h) {
          const float p = expf(leaky(wd[h] + ws[h] + wa[h], slope)
                               - m[dl * H + h]);
          st_p[tid * H + h] = p;
          atomicAdd(&den[dl * H + h], p);
        }
        st_src[tid] = s;
      }
    }
    st_dl[tid] = dl;
    __syncthreads();

    const int n_st = min(kThreads, e_hi - base);
    for (int i0 = warp * kUnroll; i0 < n_st; i0 += kThreads / 32 * kUnroll) {
      int dls[kUnroll], ss[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u;
        dls[u] = i < n_st ? st_dl[i] : -1;
        ss[u] = dls[u] >= 0 ? st_src[i] : 0;
      }
      float v[kUnroll][kMaxCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int c = lane + 32 * k;
          v[u][k] = (dls[u] >= 0 && c < HD)
              ? nf[(size_t)ss[u] * HD + c] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dls[u] < 0) continue;  // warp-uniform
        const float* p = st_p + (i0 + u) * H;
        float* acc = num + dls[u] * HD;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int c = lane + 32 * k;
          if (c < HD) atomicAdd(&acc[c], p[c / D] * v[u][k]);
        }
      }
    }
    __syncthreads();
  }

  // 5. normalise and write the tile
  for (int i = tid; i < tn * HD; i += kThreads) {
    const int n = i / HD, h = (i - n * HD) / D;
    const float dn = den[n * H + h];
    out[row0 * HD + i] = num[i] / (dn == 0.f ? 1.f : dn);
  }
  for (int i = tid; i < tn * H; i += kThreads) {
    m_out[row0 * H + i] = m[i];
    den_out[row0 * H + i] = den[i];
  }
}

int launch(const void* wn, const void* nf, const void* w_ea, const void* src,
           const void* dst, const void* emask, const void* t0,
           const void* ew_blk, const void* cw, void* out, void* m, void* den,
           int n_grid, int tn, int te, int H, int D, int self_loops,
           float slope, void* stream) {
  if (H * D > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)tn * H * D + 2 * (size_t)tn * H
                                       + (size_t)kThreads * (H + 2));
  cudaError_t err = cudaFuncSetAttribute(
      tcsr_gat_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tcsr_gat_fwd_kernel<<<n_grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wn, (const float*)nf, (const float*)w_ea,
      (const int*)src, (const int*)dst, (const float*)emask,
      (const int*)t0, (const int*)ew_blk, (const int*)cw, (float*)out,
      (float*)m, (float*)den, tn, te, H, D, self_loops, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tcsr_gat_fwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* ew_blk, const void* cw,
    void* out, void* m, void* den, int n_tiles, int tn, int te, int H,
    int D, int self_loops, float slope, void* stream) {
  return launch(wn, nf, w_ea, src, dst, emask, nullptr, ew_blk, cw, out, m,
                den, n_tiles, tn, te, H, D, self_loops, slope, stream);
}

// K3's forward: one shard's grid of n_grid tiles from tile *t0 (device).
extern "C" int tcsr_gat_ep_fwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* t0, const void* ew_blk,
    const void* cw, void* out, void* m, void* den, int n_grid, int tn,
    int te, int H, int D, float slope, void* stream) {
  return launch(wn, nf, w_ea, src, dst, emask, t0, ew_blk, cw, out, m, den,
                n_grid, tn, te, H, D, 0, slope, stream);
}

extern "C" const char* tcsr_gat_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_ep_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
