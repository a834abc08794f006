// Dense-attr GAT backward pass, part 2: the per-edge logit gradient, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_attr_emit_kernel
// (l.359), pallas_call at l.538, with the flat_slot gather and mask product
// that op_bwd applies to its output (l.610-611). Same function: for every
// edge e that the forward counted at tile t = dst[e] / tn (e inside the
// tile's TCSR edge window [ew_blk[t]*te, (ew_blk[t]+cw[t])*te), emask[e] > 0,
// src[e] in tile t),
//   d_wea[e, h] = dz[t, h*tn + dst[e] mod tn, src[e] mod tn] * emask[e]
// and d_wea[e, h] = 0 for every other edge; d_wea is (E, H) f32 and dz the
// (n_tiles, H*tn, tn) d_zpre planes of dense_attr_bwd.cu.
//
// What bounds it on this card: E*H*4 bytes written, ~4 words read per edge
// and H scattered 4-byte reads of the planes per counted edge: a gather of a
// few hundred KB at most, so launch latency.
//
// Design: the TPU kernel selects each te-edge chunk's values with a one-hot
// (te, tn) x (tn, tn) matmul per head and writes them to a tiled edge space
// that op_bwd gathers back through flat_slot, because Mosaic has no cheap
// indexed load. Here one thread per edge checks the edge against its tile's
// window and reads its H values directly, writing (E, H) in edge order, as
// the TCSR backward (tcsr_gat_bwd.cu) writes its d_w_ea.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) dense_attr_emit_kernel(
    const float* __restrict__ dz,       // (n_tiles, H*tn, tn)
    const int32_t* __restrict__ src,    // (E,)
    const int32_t* __restrict__ dst,    // (E,)
    const float* __restrict__ emask,    // (E,)
    const int32_t* __restrict__ ew_blk, // (n_tiles,)
    const int32_t* __restrict__ cw,     // (n_tiles,)
    float* __restrict__ d_wea,          // (E, H)
    int n_tiles, int tn, int H, int E, int te) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const float em = emask[e];
  const int d = dst[e], s = src[e];
  const int t = d >= 0 ? d / tn : -1;
  bool keep = em > 0.f && t >= 0 && t < n_tiles && s >= t * tn
              && s < (t + 1) * tn;
  if (keep) {
    const int lo = ew_blk[t] * te;
    keep = e >= lo && e < lo + cw[t] * te;
  }
  float* row = d_wea + (size_t)e * H;
  if (!keep) {
    for (int h = 0; h < H; ++h) row[h] = 0.f;
    return;
  }
  const size_t plane = (size_t)tn * tn;
  const float* base = dz + (size_t)t * H * plane
                      + (size_t)(d - t * tn) * tn + (s - t * tn);
  for (int h = 0; h < H; ++h) row[h] = base[h * plane] * em;
}

}  // namespace

extern "C" int dense_attr_emit(
    const void* dz, const void* src, const void* dst, const void* emask,
    const void* ew_blk, const void* cw, void* d_wea, int n_tiles, int tn,
    int H, int E, int te, void* stream) {
  if (E == 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  dense_attr_emit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dz, (const int32_t*)src, (const int32_t*)dst,
      (const float*)emask, (const int32_t*)ew_blk, (const int32_t*)cw,
      (float*)d_wea, n_tiles, tn, H, E, te);
  return (int)cudaGetLastError();
}

extern "C" const char* dense_attr_emit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
