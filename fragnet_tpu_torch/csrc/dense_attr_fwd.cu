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
//   zpre = (wd[i,h] + ws[j,h]) + W_h[i,j];  z = leaky(zpre) where adj > 0, else -1e30
//   m = max_j z   (with self_loops: m = max(m, leaky(wd[i,h] + ws[i,h])))
//   p = exp(z - m) * adj;  den = sum_j p   (+ ps = exp(zs - m) with self_loops)
//   out[i, h*D:(h+1)*D] = (sum_j p * nf[j] + ps * nf[i]) / (den, or 1 where 0)
// emitting out (N, H*D), m and den (N, H). Self-loops are folded into every
// row of the tile, padding included, as the TPU kernel folds them.
//
// What bounds it on this card: reading the adjacency plane (tn*tn*4 bytes
// per tile) and, for each of the few nonzeros per row, one nf row (H*D f32)
// and the edge's H logit terms; a few flops per byte, so bytes, and at the
// batch sizes of training (2-6 tiles a level) latency: how many SMs have
// work and how many rounds of dependent loads each warp waits on. The first
// port (a block per (tile, 32 rows): 24 blocks at the finetune atom level,
// 8 at frag and fconn; a serial fill of a 32 x tn slot table before any row
// work; per nonzero an H loop with lanes along D, one nf row per step) ran
// at 3% of its byte bound.
//
// Design: a block takes one slice of kRows destination rows of one tile
// (grid: tn / kRows slices x tiles), a warp per row. The TPU kernel
// scatters each te-edge chunk of w_ea into H dense (tn, tn) planes with
// one-hot matmuls, because Mosaic has no cheap indexed load; here no W
// plane exists. The block scans the tile's window once, in rounds of
// kThreads edges, each thread one edge, and records the counted edges of
// its slice in a kRows x tn map of edge ids in shared memory (cleared
// first, so a nonzero without a counted edge reads -1: W = 0). The warp
// reads its adjacency row once in float4 and lists the nonzero columns in
// column order by ballots (as dense_gat_fwd.cu does). Lanes then take the
// listed nonzeros 32 at a time, one each: a lane reads ws[j] and the edge's
// w_ea and computes the logits of every head; the per-head max and sum are
// butterfly shuffles (a fixed order), p goes to shared memory, and a chunk
// after the first rescales the running sums (a hub row of more than 32
// nonzeros). The aggregation has lanes along H*D (a lane's four columns lie
// in one head) and reads the nf[j] rows in float4, kUnroll rows in flight;
// the first kUnroll rows are requested before the softmax. The self-loop
// comes last, from the row's own nf row requested at the start. out is
// acc / den, a division: a row with one neighbour and no self-loop gets
// out == nf[j] bit for bit, which the backward's exact cancellation
// (d_zpre = P * (g.nf[j] - s), dense_attr_bwd.cu) needs. The adjacency is
// addressed through its tile stride, so the fconn level's first tn rows of
// the R = 6 planes are read in place. At most one counted edge per slot is
// assumed (packing.dp_level_ok; the host builder refuses repeated pairs).
// The summation order is fixed, so the result is the same from run to run.
//
// dense_attr_fwd_bf16 is the same kernel with nf in bf16 (the JAX package's
// bf16 compute, dense_gat.py:_build_attr's dt_name, l.476-479): each nf row
// read (the neighbours' and the row's own) takes a lane's four columns as
// one 8-byte load, widened to f32 exactly; the adjacency, wd, ws, w_ea, the
// softmax and the sums stay f32, and out, m, den are written in f32. A
// one-neighbour row's out is nf[j] widened, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned short bf16_bits;  // one bf16 value, as stored

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 8;              // destination rows per block, a warp each
constexpr int kThreads = 32 * kRows;  // also the window edges of one round
constexpr int kUnroll = 4;            // nf rows a warp has in flight
constexpr int kMaxTn = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* adj;     // (n_tiles, tn, tn), tile stride adj_stride
  const float* wd;      // (N, H)
  const float* ws;      // (N, H)
  const void* nf;       // (N, H*D), f32 or bf16 (the kernel's T)
  const float* w_ea;    // (E, H)
  const int* src;       // (E,)
  const int* dst;       // (E,)
  const float* emask;   // (E,)
  const int* ew_blk;    // (n_tiles,) window starts, te blocks
  const int* cw;        // (n_tiles,) window widths, te blocks
  float* out;           // (N, H*D)
  float* m;             // (N, H)
  float* den;           // (N, H)
  long long adj_stride;
  int n_edges, tn, te, D, self_loops;
  float slope;
};

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

// NV: float4 column groups per lane (H*D <= 128 * NV); T: nf's element type
template <int H, int NV, typename T>
__global__ void __launch_bounds__(kThreads) dense_attr_fwd_kernel(
    const Args a) {
  __shared__ int cols[kRows][kMaxTn];    // a warp's nonzero columns
  __shared__ float vals[kRows][kMaxTn];  // their adjacency values
  __shared__ int eid[kRows][kMaxTn];     // the edge at each slot of the slice
  __shared__ float ps[kRows][32 * H];    // p of a chunk's nonzeros

  const int tn = a.tn, D = a.D, HD = H * a.D;
  const float slope = a.slope;
  const T* nf = static_cast<const T*>(a.nf);
  const int t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int node0 = t * tn;                       // the tile's first node
  const int row0 = node0 + blockIdx.x * kRows;    // the slice's first node
  const int i = row0 - node0 + warp;              // the warp's row in the tile
  const size_t node = (size_t)node0 + i;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the slice's map cleared; the first round of the window, the adjacency
  // row and the row's own values requested
  for (int q = tid; q < kRows * tn; q += kThreads) eid[q / tn][q % tn] = -1;
  const int e_lo = a.ew_blk[t] * a.te;
  const int e_hi = min(e_lo + a.cw[t] * a.te, a.n_edges);
  int d0 = 0, s0 = 0;
  float k0 = 0.f;
  if (e_lo + tid < e_hi) {
    d0 = a.dst[e_lo + tid];
    s0 = a.src[e_lo + tid];
    k0 = a.emask[e_lo + tid];
  }
  const float* arow = a.adj + (size_t)t * a.adj_stride + (size_t)i * tn;
  float4 ad[kMaxTn / 128];
#pragma unroll
  for (int k = 0; k < kMaxTn / 128; ++k) {
    const int c = 128 * k + 4 * lane;
    ad[k] = c < tn ? ld4(arow + c) : zero4;
  }
  int col[NV], hd[NV];
  bool on[NV];
  float4 acc[NV], own[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / D : 0;
    acc[v] = zero4;
    own[v] = on[v] && a.self_loops ? ld4(nf + node * HD + col[v]) : zero4;
  }
  // per-head state, the same in every lane
  float wdi[H], wsi[H], mh[H], dh[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    wdi[h] = a.wd[node * H + h];
    wsi[h] = a.ws[node * H + h];
    mh[h] = kNeg;
    dh[h] = 0.f;
  }

  __syncthreads();  // the map is clear
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    if (e != e_lo + tid) {  // the first round was requested above
      d0 = a.dst[e];
      s0 = a.src[e];
      k0 = a.emask[e];
    }
    const int r = d0 - row0, c = s0 - node0;
    if (k0 > 0.f && r >= 0 && r < kRows && c >= 0 && c < tn) eid[r][c] = e;
  }
  __syncthreads();  // the map is complete

  // the row's nonzero columns, in column order
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kMaxTn / 128; ++k) {
    if (128 * k >= tn) break;
    const int c = 128 * k + 4 * lane;
    const float4 q = ad[k];
    const unsigned b0 = __ballot_sync(kFull, q.x > 0.f);
    const unsigned b1 = __ballot_sync(kFull, q.y > 0.f);
    const unsigned b2 = __ballot_sync(kFull, q.z > 0.f);
    const unsigned b3 = __ballot_sync(kFull, q.w > 0.f);
    int pos = n + __popc(b0 & below) + __popc(b1 & below)
              + __popc(b2 & below) + __popc(b3 & below);
    if (q.x > 0.f) { cols[warp][pos] = c; vals[warp][pos++] = q.x; }
    if (q.y > 0.f) { cols[warp][pos] = c + 1; vals[warp][pos++] = q.y; }
    if (q.z > 0.f) { cols[warp][pos] = c + 2; vals[warp][pos++] = q.z; }
    if (q.w > 0.f) { cols[warp][pos] = c + 3; vals[warp][pos++] = q.w; }
    n += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
  }
  __syncwarp();

  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cnt = min(32, n - c0);
    const int* clist = cols[warp] + c0;

    // the first kUnroll nf rows of the chunk, requested before the softmax
    float4 x[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = u < cnt;
      const size_t nj = (size_t)node0 + (ok ? clist[u] : 0);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        x[u][v] = ok && on[v] ? ld4(nf + nj * HD + col[v]) : zero4;
    }

    // lane k: nonzero c0 + k, its logits for every head
    const bool ok = lane < cnt;
    const int j = ok ? clist[lane] : 0;
    const float aij = ok ? vals[warp][c0 + lane] : 0.f;
    const int e = ok ? eid[warp][j] : -1;
    float z[H];
#pragma unroll
    for (int h = 0; h < H; ++h)
      z[h] = (wdi[h] + a.ws[((size_t)node0 + j) * H + h])
             + (e >= 0 ? a.w_ea[(size_t)e * H + h] : 0.f);
    float sc[H];  // rescale of the earlier chunks' sums
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float zz = ok ? leaky(z[h], slope) : kNeg;
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
        const size_t nj = (size_t)node0 + (okr ? clist[b0 + u] : 0);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          x[u][v] = okr && on[v] ? ld4(nf + nj * HD + col[v]) : zero4;
      }
    }
    __syncwarp();  // the next chunk rewrites ps
  }

  // the self-loop, folded in last
  if (a.self_loops) {
    float pself[H], sc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float zs = leaky(wdi[h] + wsi[h], slope);
      const float mn = fmaxf(mh[h], zs);
      sc[h] = expf(mh[h] - mn);
      pself[h] = expf(zs - mn);
      dh[h] = dh[h] * sc[h] + pself[h];
      mh[h] = mn;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        s = h == hd[v] ? sc[h] : s;
        q = h == hd[v] ? pself[h] : q;
      }
      acc[v].x = acc[v].x * s + q * own[v].x;
      acc[v].y = acc[v].y * s + q * own[v].y;
      acc[v].z = acc[v].z * s + q * own[v].z;
      acc[v].w = acc[v].w * s + q * own[v].w;
    }
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!on[v]) continue;
    float dn = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) dn = h == hd[v] ? dh[h] : dn;
    const float q = dn == 0.f ? 1.f : dn;
    *reinterpret_cast<float4*>(a.out + node * HD + col[v]) = make_float4(
        acc[v].x / q, acc[v].y / q, acc[v].z / q, acc[v].w / q);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (lane == h) {
      a.m[node * H + h] = mh[h];
      a.den[node * H + h] = dh[h];
    }
  }
}

template <int H, int NV, typename T>
int launch(const Args& a, int n_tiles, cudaStream_t stream) {
  const dim3 grid(a.tn / kRows, n_tiles);
  dense_attr_fwd_kernel<H, NV, T><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int H, typename T>
int launch_nv(const Args& a, int n_tiles, cudaStream_t s) {
  return H * a.D <= 128 ? launch<H, 1, T>(a, n_tiles, s)
                        : launch<H, 2, T>(a, n_tiles, s);
}

template <typename T>
int launch_h(const void* adj, const void* wd, const void* ws, const void* nf,
             const void* w_ea, const void* src, const void* dst,
             const void* emask, const void* ew_blk, const void* cw,
             void* out, void* m, void* den, long long adj_stride,
             int n_tiles, int tn, int H, int D, int E, int te,
             int self_loops, float slope, void* stream) {
  // lanes read the adjacency rows and nf four columns at a time, a lane's
  // four columns in one head: tn in {32, 64, 128, 256}, D a multiple of 4,
  // H*D <= 256
  if ((tn != 32 && tn != 64 && tn != 128 && tn != 256) || D <= 0 || D % 4
      || H * D > 256 || n_tiles < 0 || E < 0 || te <= 0 || adj_stride % 4)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const Args a{(const float*)adj, (const float*)wd, (const float*)ws, nf,
               (const float*)w_ea, (const int*)src, (const int*)dst,
               (const float*)emask, (const int*)ew_blk, (const int*)cw,
               (float*)out, (float*)m, (float*)den, adj_stride, E, tn, te,
               D, self_loops, slope};
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 1: return launch_nv<1, T>(a, n_tiles, s);
    case 2: return launch_nv<2, T>(a, n_tiles, s);
    case 4: return launch_nv<4, T>(a, n_tiles, s);
    case 8: return launch_nv<8, T>(a, n_tiles, s);
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
  return launch_h<float>(adj, wd, ws, nf, w_ea, src, dst, emask, ew_blk, cw,
                         out, m, den, adj_stride, n_tiles, tn, H, D, E, te,
                         self_loops, slope, stream);
}

// nf in bf16 (8-byte aligned rows); every other argument as above
extern "C" int dense_attr_fwd_bf16(
    const void* adj, const void* wd, const void* ws, const void* nf,
    const void* w_ea, const void* src, const void* dst, const void* emask,
    const void* ew_blk, const void* cw, void* out, void* m, void* den,
    long long adj_stride, int n_tiles, int tn, int H, int D, int E, int te,
    int self_loops, float slope, void* stream) {
  return launch_h<bf16_bits>(adj, wd, ws, nf, w_ea, src, dst, emask, ew_blk,
                             cw, out, m, den, adj_stride, n_tiles, tn, H, D,
                             E, te, self_loops, slope, stream);
}

extern "C" const char* dense_attr_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* dense_attr_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
