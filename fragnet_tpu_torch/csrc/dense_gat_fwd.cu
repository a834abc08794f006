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
// What bounds it on this card: the adjacency planes, tn*tn*4 bytes per tile,
// the attribute values at the nonzeros and one nf row per nonzero; the
// adjacency is sparse (a molecule node has a handful of neighbours), so the
// work is a few flops per byte and, at the batch sizes of training, the
// kernel is bound by latency: how many SMs have work and how many rounds of
// dependent loads each warp waits on. The first port (a block per (tile, 32
// rows), each restaging the tile's whole nf in shared memory and reading
// every attribute plane in full) ran at 2-6% of its byte bound with 8 blocks
// at the finetune fconn level.
//
// Design: a block takes one slice of kRows destination rows of one tile
// (grid: tn / kRows slices x tiles), a warp per row, nothing staged per
// tile. The warp reads its adjacency row once in float4 and lists the
// nonzero columns in column order by four ballots (no scan). Lanes then
// take the listed nonzeros 32 at a time, one each: a lane loads ws[j] and
// the R attribute values at (i, j) only, and computes the logits of every
// head; the per-head max and sum are butterfly shuffles (a fixed order), p
// goes to shared memory, and a chunk after the first rescales the running
// sums (a hub row of more than 32 nonzeros). The aggregation has lanes
// along H*D (a lane's four columns lie in one head) and reads the nf[j]
// rows from global memory / L2 in float4, kUnroll rows in flight; the first
// kUnroll rows are requested before the softmax, so a row of a few
// nonzeros waits on two rounds of loads after its adjacency row. out is
// acc / den, a division: a row with one neighbour gets out == nf[j] bit for
// bit, which the backward's exact cancellation (d_zpre = P * (g.nf[j] - s))
// needs. The summation order is fixed, so the result is the same from run
// to run. The TPU kernel's (8, .) paddings of wsT and vc and its
// G-tiles-per-step loop are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 8;              // destination rows per block, a warp each
constexpr int kThreads = 32 * kRows;
constexpr int kUnroll = 4;            // nf rows a warp has in flight
constexpr int kMaxTn = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int H, int NV>  // float4 column groups per lane: H*D <= 128 * NV
__global__ void __launch_bounds__(kThreads) dense_gat_fwd_kernel(
    const float* __restrict__ planes,  // (n_tiles, (R+1)*tn, tn)
    const float* __restrict__ wd,      // (N, H)
    const float* __restrict__ ws,      // (N, H)
    const float* __restrict__ nf,      // (N, H*D)
    const float* __restrict__ vc,      // (R+1, H): rows v[0..R-1], then c
    float* __restrict__ out,           // (N, H*D)
    float* __restrict__ m_out,         // (N, H)
    float* __restrict__ den_out,       // (N, H)
    int tn, int D, int R, float slope) {
  __shared__ float vc_s[32 * H];          // (R+1) x H, R < 32
  __shared__ int cols[kRows][kMaxTn];     // a warp's nonzero columns
  __shared__ float vals[kRows][kMaxTn];   // their adjacency values
  __shared__ float ps[kRows][32 * H];     // p of a chunk's nonzeros

  const int t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kRows + warp;  // the warp's row in the tile
  const size_t tile0 = (size_t)t * tn;       // the tile's first node
  const size_t node = tile0 + i;
  const int HD = H * D;
  const size_t plane = (size_t)tn * tn;
  const float* tile = planes + (size_t)t * (R + 1) * plane;
  for (int q = tid; q < (R + 1) * H; q += kThreads) vc_s[q] = vc[q];

  // the adjacency row, read once; its nonzero columns listed in order
  const float* arow = tile + (size_t)i * tn;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int c0 = 0; c0 < tn; c0 += 128) {
    const int c = c0 + 4 * lane;
    const float4 a = c < tn ? ld4(arow + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned b0 = __ballot_sync(kFull, a.x > 0.f);
    const unsigned b1 = __ballot_sync(kFull, a.y > 0.f);
    const unsigned b2 = __ballot_sync(kFull, a.z > 0.f);
    const unsigned b3 = __ballot_sync(kFull, a.w > 0.f);
    int pos = n + __popc(b0 & below) + __popc(b1 & below)
              + __popc(b2 & below) + __popc(b3 & below);
    if (a.x > 0.f) { cols[warp][pos] = c; vals[warp][pos++] = a.x; }
    if (a.y > 0.f) { cols[warp][pos] = c + 1; vals[warp][pos++] = a.y; }
    if (a.z > 0.f) { cols[warp][pos] = c + 2; vals[warp][pos++] = a.z; }
    if (a.w > 0.f) { cols[warp][pos] = c + 3; vals[warp][pos++] = a.w; }
    n += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
  }
  __syncthreads();  // vc_s and the lists

  int col[NV], hd[NV];
  bool on[NV];
  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / D : 0;
    acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // per-head state, the same in every lane
  float wdi[H], mh[H], dh[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    wdi[h] = wd[node * H + h];
    mh[h] = kNeg;
    dh[h] = 0.f;
  }

  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cnt = min(32, n - c0);
    const int* clist = cols[warp] + c0;

    // the first kUnroll nf rows of the chunk, requested before the softmax
    float4 x[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = u < cnt;
      const size_t nj = tile0 + (ok ? clist[u] : 0);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        x[u][v] = ok && on[v] ? ld4(nf + nj * HD + col[v])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // lane k: nonzero c0 + k, its logits for every head
    const bool ok = lane < cnt;
    const int j = ok ? clist[lane] : 0;
    const float aij = ok ? vals[warp][c0 + lane] : 0.f;
    float z[H];
#pragma unroll
    for (int h = 0; h < H; ++h) z[h] = wdi[h] + ws[(tile0 + j) * H + h];
    const float* ea = tile + plane + (size_t)i * tn + j;
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float e = ok ? ea[(size_t)r * plane] : 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) z[h] += e * vc_s[r * H + h];
    }
    float sc[H];  // rescale of the earlier chunks' sums
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float zz = ok ? leaky(z[h] + vc_s[R * H + h], slope) : kNeg;
      float mx = zz;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(mh[h], mx);
      sc[h] = expf(mh[h] - mn);
      const float p = ok ? expf(zz - mn) * aij : 0.f;
      ps[warp][lane * H + h] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      dh[h] = dh[h] * sc[h] + sum;
      mh[h] = mn;
    }
    __syncwarp();

    // aggregation: lanes along H*D, kUnroll rows at a time
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float s = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) s = h == hd[v] ? sc[h] : s;
      acc[v].x *= s;
      acc[v].y *= s;
      acc[v].z *= s;
      acc[v].w *= s;
    }
    for (int b0 = 0;;) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u >= cnt) break;  // warp-uniform
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float p = ps[warp][(b0 + u) * H + hd[v]];
          acc[v].x += p * x[u][v].x;
          acc[v].y += p * x[u][v].y;
          acc[v].z += p * x[u][v].z;
          acc[v].w += p * x[u][v].w;
        }
      }
      b0 += kUnroll;
      if (b0 >= cnt) break;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool okr = b0 + u < cnt;
        const size_t nj = tile0 + (okr ? clist[b0 + u] : 0);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          x[u][v] = okr && on[v] ? ld4(nf + nj * HD + col[v])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncwarp();  // the next chunk rewrites ps
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!on[v]) continue;
    float dn = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) dn = h == hd[v] ? dh[h] : dn;
    const float q = dn == 0.f ? 1.f : dn;
    *reinterpret_cast<float4*>(out + node * HD + col[v]) = make_float4(
        acc[v].x / q, acc[v].y / q, acc[v].z / q, acc[v].w / q);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (lane == h) {
      m_out[node * H + h] = mh[h];
      den_out[node * H + h] = dh[h];
    }
  }
}

template <int H, int NV>
int launch(const float* planes, const float* wd, const float* ws,
           const float* nf, const float* vc, float* out, float* m,
           float* den, int n_tiles, int tn, int D, int R, float slope,
           cudaStream_t stream) {
  const dim3 grid(tn / kRows, n_tiles);
  dense_gat_fwd_kernel<H, NV><<<grid, kThreads, 0, stream>>>(
      planes, wd, ws, nf, vc, out, m, den, tn, D, R, slope);
  return (int)cudaGetLastError();
}

template <int H>
int launch_nv(const float* planes, const float* wd, const float* ws,
              const float* nf, const float* vc, float* out, float* m,
              float* den, int n_tiles, int tn, int D, int R, float slope,
              cudaStream_t s) {
  if (H * D <= 128)
    return launch<H, 1>(planes, wd, ws, nf, vc, out, m, den, n_tiles, tn, D,
                        R, slope, s);
  return launch<H, 2>(planes, wd, ws, nf, vc, out, m, den, n_tiles, tn, D, R,
                      slope, s);
}

}  // namespace

extern "C" int dense_gat_fwd(
    const void* planes, const void* wd, const void* ws, const void* nf,
    const void* vc, void* out, void* m, void* den, int n_tiles, int tn,
    int H, int D, int R, float slope, void* stream) {
  // lanes read the adjacency and nf in float4 (a lane's four columns in one
  // head): tn in {32, 64, 128, 256}, D a multiple of 4, H*D <= 256
  if ((tn != 32 && tn != 64 && tn != 128 && tn != 256) || D <= 0 || D % 4
      || H * D > 256 || R < 0 || R + 1 > 32)
    return (int)cudaErrorInvalidValue;
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
    case 1: return launch_nv<1>(p, a, b, x, v, o, mm, dd, n_tiles, tn, D, R, slope, s);
    case 2: return launch_nv<2>(p, a, b, x, v, o, mm, dd, n_tiles, tn, D, R, slope, s);
    case 4: return launch_nv<4>(p, a, b, x, v, o, mm, dd, n_tiles, tn, D, R, slope, s);
    case 8: return launch_nv<8>(p, a, b, x, v, o, mm, dd, n_tiles, tn, D, R, slope, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dense_gat_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
