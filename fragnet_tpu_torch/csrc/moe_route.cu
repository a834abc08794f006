// The token dispatch and the weighted combine of a mixture-of-experts layer
// that holds some of the experts (model/moonlight.py), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. Without
// these, the port would move rows by a routing with torch's indexing, whose
// backward (index_add_) sums a token's rows with atomics in an order that
// changes from run to run. These kernels give the same bits on every run.
//
// Function, for rows of width D (f32), a token's K routing slots in the
// order the router ranked them, pos[t, k] the row of slot k of token t in
// the expert-sorted buffer (-1 where its expert is not held here, and for
// every slot of a padding token) and tok[r] the token of sorted row r:
//   gather:            out[r, :] = x[tok[r], :]                      r < A
//   combine:           out[t, :] = sum over k in order, pos[t, k] >= 0, of
//                                  w[t, k] * y[pos[t, k], :]
//                      (w absent: the rows themselves, the gather's
//                      backward)
//   combine backward:  d_y[pos[t, k], :] = w[t, k] * d_out[t, :]
//                      d_w[t, k] = <y[pos[t, k], :], d_out[t, :]>, 0 where
//                      pos[t, k] < 0
// The combine starts each row at 0 and adds the slots' products in slot
// order, each product and each sum rounded once (__fmul_rn, __fadd_rn: no
// contraction into an FMA), as the plain version (ops/moe.py:
// combine_plain) computes it, so the two agree bit for bit; d_y is one
// product, equal too. d_w's dot is summed in a fixed order (each thread's
// columns in order, then a fixed tree): the same bits on every run.
//
// What bounds it on this card: bytes. At the DTA cell's step (T = 32,000
// token rows of D = 2048, ~18k rows on the 8 experts held) the gather moves
// ~0.3 GB, the combine and the gather's backward ~0.4 GB each and the
// combine's backward ~0.45 GB a layer: ~0.45 ms in all at 3.35 TB/s.
//
// Design: a block of 128 threads takes one row (gather: a sorted row;
// combine and its backward: a token), each thread float4 columns at a
// stride of 128, unrolled so that its loads are in flight together. The
// combine keeps a token's K row indices and weights in registers (K <= 8);
// a token with no slot held here writes zeros (combine) or its K zeros of
// d_w (backward) and reads nothing else. No atomics, no shared state
// between blocks. The wrapper checks D % 4 == 0 and 16-byte aligned rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 8;

__global__ void __launch_bounds__(kThreads)
moe_gather_kernel(const float4* __restrict__ x, const int* __restrict__ tok,
                  float4* __restrict__ out, int A, int D4) {
  for (int r = blockIdx.x; r < A; r += gridDim.x) {
    const float4* src = x + (long long)tok[r] * D4;
    float4* dst = out + (long long)r * D4;
#pragma unroll 4
    for (int c = threadIdx.x; c < D4; c += kThreads) dst[c] = src[c];
  }
}

__device__ __forceinline__ float4 fma_rn(float4 acc, float w, float4 y) {
  // acc + w * y, the product and the sum each rounded once
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, y.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, y.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, y.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, y.w));
  return acc;
}

__device__ __forceinline__ float4 add_rn(float4 acc, float4 y) {
  acc.x = __fadd_rn(acc.x, y.x);
  acc.y = __fadd_rn(acc.y, y.y);
  acc.z = __fadd_rn(acc.z, y.z);
  acc.w = __fadd_rn(acc.w, y.w);
  return acc;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const float4* __restrict__ y, const int* __restrict__ pos,
                   const float* __restrict__ w, float4* __restrict__ out,
                   int T, int K, int D4) {
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    int p[kMaxK];
    float wk[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      p[k] = k < K ? pos[(long long)t * K + k] : -1;
      wk[k] = (kWeighted && p[k] >= 0) ? w[(long long)t * K + k] : 1.0f;
    }
    float4* dst = out + (long long)t * D4;
#pragma unroll 4
    for (int c = threadIdx.x; c < D4; c += kThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (p[k] < 0) continue;
        const float4 v = y[(long long)p[k] * D4 + c];
        acc = kWeighted ? fma_rn(acc, wk[k], v) : add_rn(acc, v);
      }
      dst[c] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
moe_combine_bwd_kernel(const float4* __restrict__ y,
                       const int* __restrict__ pos,
                       const float* __restrict__ w,
                       const float4* __restrict__ d_out,
                       float4* __restrict__ d_y, float* __restrict__ d_w,
                       int T, int K, int D4) {
  __shared__ float red[kThreads / 32][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    int p[kMaxK];
    float wk[kMaxK];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      p[k] = k < K ? pos[(long long)t * K + k] : -1;
      wk[k] = p[k] >= 0 ? w[(long long)t * K + k] : 0.0f;
      any |= p[k] >= 0;
    }
    if (!any) {  // uniform across the block: no slot of this token is held
      if (threadIdx.x < K) d_w[(long long)t * K + threadIdx.x] = 0.0f;
      continue;
    }
    float part[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) part[k] = 0.0f;
    const float4* g = d_out + (long long)t * D4;
#pragma unroll 2
    for (int c = threadIdx.x; c < D4; c += kThreads) {
      const float4 d = g[c];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (p[k] < 0) continue;
        const long long at = (long long)p[k] * D4 + c;
        const float4 v = y[at];
        d_y[at] = make_float4(__fmul_rn(wk[k], d.x), __fmul_rn(wk[k], d.y),
                              __fmul_rn(wk[k], d.z), __fmul_rn(wk[k], d.w));
        part[k] = fmaf(v.x, d.x, part[k]);
        part[k] = fmaf(v.y, d.y, part[k]);
        part[k] = fmaf(v.z, d.z, part[k]);
        part[k] = fmaf(v.w, d.w, part[k]);
      }
    }
    // each slot's dot: a fixed butterfly within the warp, then the warps'
    // sums in warp order
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      float s = part[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < K) {
      const int k = threadIdx.x;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) s += red[i][k];
      d_w[(long long)t * K + k] = p[k] >= 0 ? s : 0.0f;
    }
    __syncthreads();
  }
}

int grid_for(long long rows) {
  // enough blocks to fill the card many times over; blocks loop past this
  const long long cap = 1 << 20;
  return (int)(rows < cap ? rows : cap);
}

}  // namespace

// out (A, D) = x[tok] for the A sorted rows; D4 = D / 4
extern "C" int moe_gather(const void* x, const void* tok, void* out,
                          long long A, long long D4, void* stream) {
  if (A == 0) return (int)cudaSuccess;
  moe_gather_kernel<<<grid_for(A), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const int*)tok, (float4*)out, (int)A, (int)D4);
  return (int)cudaGetLastError();
}

// out (T, D): each token's held slots' rows of y, weighted by w where w is
// not null, summed in slot order
extern "C" int moe_combine(const void* y, const void* pos, const void* w,
                           void* out, long long T, long long K, long long D4,
                           void* stream) {
  if (T == 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (w != nullptr) {
    moe_combine_kernel<true><<<grid_for(T), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float4*)y, (const int*)pos, (const float*)w, (float4*)out,
        (int)T, (int)K, (int)D4);
  } else {
    moe_combine_kernel<false><<<grid_for(T), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float4*)y, (const int*)pos, nullptr, (float4*)out, (int)T,
        (int)K, (int)D4);
  }
  return (int)cudaGetLastError();
}

// d_y (A, D) and d_w (T, K) of the weighted combine, for d_out (T, D)
extern "C" int moe_combine_bwd(const void* y, const void* pos, const void* w,
                               const void* d_out, void* d_y, void* d_w,
                               long long T, long long K, long long D4,
                               void* stream) {
  if (T == 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  moe_combine_bwd_kernel<<<grid_for(T), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)y, (const int*)pos, (const float*)w,
      (const float4*)d_out, (float4*)d_y, (float*)d_w, (int)T, (int)K,
      (int)D4);
  return (int)cudaGetLastError();
}

extern "C" const char* moe_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* moe_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* moe_combine_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
