// Device plane builder for the dense per-tile GAT kernels, for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/dense_gat.py:_plane_builder_kernel
// (l.105), built by _build_plane_builder (l.144) and entered through
// build_dense_planes_device (l.168). Same function: for destination tile t
// of tn nodes and every edge e of the tile's TCSR edge window (the te-edge
// blocks ew_blk[t] .. ew_blk[t] + cw[t] - 1) with edge_mask[e] > 0 and both
// endpoints inside tile t,
//   out[t, dst_e mod tn, src_e mod tn]                += 1
//   out[t, (r+1)*tn + dst_e mod tn, src_e mod tn]     += ea[e, r],  r < R
// and 0 everywhere else: out is (n_tiles, (R+1)*tn, tn) f32, the layout of
// the host builder ops/dense_gat.py:build_dense_planes. The TPU kernel forms
// these sums as one-hot matmuls over each (tile, chunk); here every kept
// edge adds its values directly.
//
// What bounds it on this card: writing the planes, n_tiles*(R+1)*tn*tn*4
// bytes (64 KiB per bond tile at tn = 128, 448 KiB per fconn tile), against
// reading ~(3+R)*4 bytes per edge; the planes are almost all zeros (a node
// has a handful of neighbours in a tile of 128).
//
// Design: one block per tile. The block zero-fills its slab with 16-byte
// stores (neighbouring threads on neighbouring addresses), synchronises, then
// one thread per edge of the window adds its 1 + R values with atomicAdd.
// The atomics keep the sum semantics of the TPU kernel where a (dst, src)
// pair repeats; packing.dp_level_ok rules that out on the packed path, so
// every slot receives at most one value and the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int R, int TN>
__global__ void __launch_bounds__(kThreads) dense_planes_kernel(
    const int32_t* __restrict__ src,    // (E,)
    const int32_t* __restrict__ dst,    // (E,)
    const float* __restrict__ emask,    // (E,)
    const float* __restrict__ ea,       // (E, R); unused when R == 0
    const int32_t* __restrict__ ew_blk, // (n_tiles,) window start, te blocks
    const int32_t* __restrict__ cw,     // (n_tiles,) window width, te blocks
    float* __restrict__ out,            // (n_tiles, (R+1)*TN, TN)
    int E, int te) {
  constexpr int kPlane = TN * TN;
  constexpr int kSlab4 = (R + 1) * kPlane / 4;
  const int t = blockIdx.x;
  float* slab = out + (size_t)t * (R + 1) * kPlane;
  float4* slab4 = reinterpret_cast<float4*>(slab);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kSlab4; i += kThreads) slab4[i] = zero;
  __syncthreads();  // the zeros are visible to the block's atomics below

  const int node0 = t * TN;
  const int e0 = ew_blk[t] * te;
  const int e1 = min(e0 + cw[t] * te, E);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    if (!(emask[e] > 0.f)) continue;
    const int d = dst[e] - node0;
    const int s = src[e] - node0;
    if (d < 0 || d >= TN || s < 0 || s >= TN) continue;
    const int slot = d * TN + s;
    atomicAdd(slab + slot, 1.f);
#pragma unroll
    for (int r = 0; r < R; ++r)
      atomicAdd(slab + (r + 1) * kPlane + slot, ea[(size_t)e * R + r]);
  }
}

template <int R, int TN>
int launch(const int32_t* src, const int32_t* dst, const float* emask,
           const float* ea, const int32_t* ew_blk, const int32_t* cw,
           float* out, int n_tiles, int E, int te, cudaStream_t stream) {
  if (n_tiles == 0) return 0;
  dense_planes_kernel<R, TN><<<n_tiles, kThreads, 0, stream>>>(
      src, dst, emask, ea, ew_blk, cw, out, E, te);
  return (int)cudaGetLastError();
}

template <int R>
int launch_tn(int tn, const int32_t* src, const int32_t* dst,
              const float* emask, const float* ea, const int32_t* ew_blk,
              const int32_t* cw, float* out, int n_tiles, int E, int te,
              cudaStream_t s) {
  switch (tn) {
    case 32: return launch<R, 32>(src, dst, emask, ea, ew_blk, cw, out, n_tiles, E, te, s);
    case 64: return launch<R, 64>(src, dst, emask, ea, ew_blk, cw, out, n_tiles, E, te, s);
    case 128: return launch<R, 128>(src, dst, emask, ea, ew_blk, cw, out, n_tiles, E, te, s);
    case 256: return launch<R, 256>(src, dst, emask, ea, ew_blk, cw, out, n_tiles, E, te, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_planes(
    const void* src, const void* dst, const void* emask, const void* ea,
    const void* ew_blk, const void* cw, void* out, int n_tiles, int tn,
    int R, int E, int te, void* stream) {
  const int32_t* s_ = (const int32_t*)src;
  const int32_t* d_ = (const int32_t*)dst;
  const float* m_ = (const float*)emask;
  const float* a_ = (const float*)ea;
  const int32_t* w_ = (const int32_t*)ew_blk;
  const int32_t* c_ = (const int32_t*)cw;
  float* o_ = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 0: return launch_tn<0>(tn, s_, d_, m_, a_, w_, c_, o_, n_tiles, E, te, st);
    case 1: return launch_tn<1>(tn, s_, d_, m_, a_, w_, c_, o_, n_tiles, E, te, st);
    case 6: return launch_tn<6>(tn, s_, d_, m_, a_, w_, c_, o_, n_tiles, E, te, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_planes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
