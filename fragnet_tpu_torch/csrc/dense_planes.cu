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
// has a handful of neighbours in a tile of 128). The first port ran one
// block per tile, which zero-filled its slab in global memory and then
// added the edges with global atomics: every written slot was stored twice,
// and at the batch-512 fconn level (~18 tiles) 18 blocks ran on 132 SMs.
//
// Design: one block per (tile, slice of kS destination rows); the block owns
// rows [r0, r0 + kS) of all R + 1 planes of its tile, kS*tn*(R+1)*4 bytes
// (56 KiB at R = 6, tn = 128, kS = 16), staged in dynamic shared memory:
//   1. clear the slice in shared memory;
//   2. scan the tile's window, one thread per edge (dst read coalesced by
//      every thread; src, the mask and the attrs only for an edge whose
//      destination lies in the slice) and add 1 and the R attrs of each kept
//      edge at its slot with shared-memory atomics — the TPU kernel's sum
//      where a (dst, src) pair repeats; packing.dp_level_ok rules that out
//      on the packed path, so every slot receives at most one value added to
//      0 and the result is exact;
//   3. write the slice out with float4 stores, plane by plane (each plane's
//      kS rows are one contiguous run of kS*tn floats).
// Every output byte is written once; no global atomics, no global fill. The
// window is read tn/kS times (once per slice) instead of once, but only its
// dst words by every slice (the rest only where the edge is the slice's),
// and from L2, which serves them at several times the HBM rate: 4 bytes an
// edge per slice against the slice's kS*tn*(R+1)*4 bytes of planes — a bond
// window of ~500 edges is 2 KiB per slice against the slice's 16 KiB, a
// fconn window a few hundred bytes against 56 KiB.
//
// Blocks per level at the batch-512 pretraining step (tn 128, kS 16: 8
// slices a tile; tiles from each level's plane bytes): fconn ~18 tiles ->
// ~144 blocks, atom ~116 -> ~930, bond ~270 -> ~2180; 132 SMs, up to 4
// blocks an SM at 56 KiB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// a block's slice: kS destination rows (16 at tn <= 128, 8 at tn = 256, so
// a slice of R = 6 planes is at most 56 KiB) and its bytes
template <int R, int TN>
struct Slice {
  static constexpr int kS = TN <= 128 ? 16 : 8;
  static constexpr int kBytes = (R + 1) * kS * TN * 4;
};

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
  constexpr int kS = Slice<R, TN>::kS;
  constexpr int kSlices = TN / kS;
  constexpr int kSlice4 = kS * TN / 4;  // float4s of one plane's slice
  constexpr int kAll4 = (R + 1) * kSlice4;
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);

  const int t = blockIdx.x / kSlices;
  const int r0 = (blockIdx.x % kSlices) * kS;
  const int e0 = ew_blk[t] * te;
  const int e1 = min(e0 + cw[t] * te, E);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kAll4; i += kThreads) smem4[i] = zero;
  __syncthreads();  // the slice is clear

  const int node0 = t * TN;
  const int row0 = node0 + r0;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const unsigned d = (unsigned)(dst[e] - row0);
    if (d >= (unsigned)kS) continue;
    const unsigned s = (unsigned)(src[e] - node0);
    if (s >= (unsigned)TN || !(emask[e] > 0.f)) continue;
    float* slot = slab + d * TN + s;
    atomicAdd(slot, 1.f);
#pragma unroll
    for (int r = 0; r < R; ++r)
      atomicAdd(slot + (r + 1) * kSlice4 * 4, ea[(size_t)e * R + r]);
  }
  __syncthreads();  // the slice is complete

  // plane p's rows [r0, r0 + kS) of tile t: one run of kS*TN floats
  float4* o = reinterpret_cast<float4*>(out + ((size_t)t * (R + 1) * TN + r0)
                                                  * TN);
  for (int i = threadIdx.x; i < kAll4; i += kThreads) {
    const int p = i / kSlice4, q = i % kSlice4;
    o[(size_t)p * (TN * TN / 4) + q] = smem4[i];
  }
}

template <int R, int TN>
int launch(const int32_t* src, const int32_t* dst, const float* emask,
           const float* ea, const int32_t* ew_blk, const int32_t* cw,
           float* out, int n_tiles, int E, int te, cudaStream_t stream) {
  if (n_tiles == 0) return 0;
  constexpr int bytes = Slice<R, TN>::kBytes;
  // above 48 KiB a block's dynamic shared memory needs the opt-in (per
  // device: set on every launch, a host-side attribute write)
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dense_planes_kernel<R, TN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  dense_planes_kernel<R, TN>
      <<<n_tiles * (TN / Slice<R, TN>::kS), kThreads, bytes, stream>>>(
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
