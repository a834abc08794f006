// Fused TCSR GAT backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel fragnet_tpu/ops/pallas_gat.py:_bwd_kernel (l.199),
// called at l.425 from the custom VJP op_bwd (l.504). Given the forward's
// inputs and its softmax state (m, den), the cotangent g of out and
// s = sum_d g * out per node and head, for every kept edge e (dst in the
// destination tile, emask > 0) and head h:
//   zpre = w_dst[dst] + w_src[src] + w_ea[e],   p = exp(leaky(zpre) - m[dst]) / den[dst]
//   d_p  = sum_d g[dst,h,d] * nf[src,h,d]
//   d_zpre = p * (d_p - s[dst]) * (zpre > 0 ? 1 : slope)
// and it emits
//   d_w_ea[e]        = d_zpre                (0 for a masked edge)
//   d_wn[dst, :H]   += d_zpre,   d_wn[src, H:] += d_zpre
//   d_nf[src]       += p * g[dst]
// plus, with self_loops, the analytic self-loop of every node n of the tile
// (p_self from zpre = w_dst[n] + w_src[n]): d_wn[n, :H] and d_wn[n, H:] both
// get d_zpre_self, and d_nf[n] += p_self * g[n] (pallas_gat.py:227-236).
// den == 0 counts as 1, as in the forward. The TPU kernel's d_a_src, d_nf_dst
// and d_wself outputs are not needed: d_wn[:, H:] is the per-source sum of
// d_zpre, so d_a_src = sum_n d_wn[n, H:] * nf[n] and the a_dst/a_src parts of
// d_nf are the transpose of the prologue, which autograd computes in torch.
//
// What bounds it on this card: the irregular reads of the g[dst] and nf[src]
// rows (H*D f32 each per edge) and the per-edge scalars, a few flops per
// byte. At the batch sizes of training a level is a handful of tiles, so the
// kernel is bound by latency: how many SMs have work and how many rounds of
// dependent loads each warp waits on. The first port (a warp per edge over a
// grid of tiles x 8 blocks, each edge a chain of dependent loads, every
// source sum a global f32 atomic into zero-filled outputs) ran at 2% of its
// byte bound and gave last-bit differences from run to run.
//
// Design: one launch, two roles, no atomics; every output element is
// written once, by its owner, in a fixed order, so the result is the same
// from run to run and no output needs a zero fill. A block of kRows warps
// takes one slice of kRows rows in one role, a warp a row; lanes run along
// H*D with float4 loads (a lane's four columns lie in one head), kUnroll
// edges' loads in flight before any is folded in.
//   * Destination role (a slice of a destination tile): the block scans the
//     tile's real window [ew_blk[t]*te, (ew_blk[t]+cw[t])*te) in rounds of
//     kThreads edges and compacts the slice's kept edges in edge order by a
//     ballot and a prefix over the warps (as the forward, tcsr_gat_fwd.cu,
//     does); the row's g, w_dst, m, den and s sit in registers. Per edge it
//     computes p and d_zpre, stores d_w_ea[e] and sums d_wn[dst, :H] in
//     edge order, then the self-loop.
//   * Source role (a slice of source nodes, every node of the batch): the
//     block lists the destination tiles whose TCSR source window
//     [sw_tile[t]*tn, (sw_tile[t]+k_src)*tn) holds the slice, in tile order,
//     and scans each one's window for kept edges whose source is in the
//     slice and whose destination is in that tile (a window also holds its
//     neighbours' edges). Per edge it recomputes p and d_zpre from the
//     destination's g, w_dst, m, den, s and sums d_nf[src] and
//     d_wn[src, H:] in (tile, edge) order, then the self-loop. It also
//     writes d_wn[n, :H] = 0 for the nodes outside the destination grid
//     (K3's shards) and d_w_ea = 0 for the masked edges of its share of the
//     edge range.
// Both roles compute p and d_zpre with the same expressions (the logit in
// the forward's association, w_dst + (w_src + w_ea)), so they agree bit for
// bit. The per-head dot g[dst]·nf[src] is summed in the order in which
// torch sums s = (g * out).sum(-1) on the card (and autograd the
// edge-partitioned pass's dV): where a row's output equals its neighbours'
// features, d_p - s is then exactly 0, as the math says, on the
// single-device and the edge-partitioned paths alike. The TPU kernel's
// one-hot gathers, its
// tiled per-edge d_z (gathered back through flat_slot) and its source-window
// d_nf slabs (folded outside the kernel) exist because Mosaic has no cheap
// indexed load or scatter; they are not carried over: the source role reads
// the TCSR source windows that the metadata already holds.
//
// tcsr_gat_ep_bwd (K3's backward) is the same kernel on one edge shard of
// the edge-partitioned pass (fragnet_tpu/ops/pallas_gat.py:_make_ep_op,
// l.635, _unnorm_bwd l.707): the destination grid is the shard's n_grid
// tiles from tile *t0 (device memory), m, den, g, s hold the grid's rows,
// and the source role still covers every node of the batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;              // rows per block, a warp each
constexpr int kThreads = 32 * kRows;  // also the window edges of one round
constexpr int kUnroll = 4;            // edges whose loads a warp has in flight
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* wn;      // (N, 2H): [w_dst | w_src]
  const float* nf;      // (N, H*D)
  const float* w_ea;    // (E, H)
  const int* src;       // (E,)
  const int* dst;       // (E,)
  const float* emask;   // (E,)
  const int* t0;        // (1,) first grid tile, or null: 0
  const int* ew_blk;    // (n_grid,) edge-window starts, te-blocks
  const int* cw;        // (n_grid,) real te-blocks per window
  const int* sw_tile;   // (n_grid,) source-window starts, tn-tiles
  const float* m;       // (n_grid * tn, H)
  const float* den;     // (n_grid * tn, H)
  const float* g;       // (n_grid * tn, H*D)
  const float* s;       // (n_grid * tn, H)
  float* d_wn;          // (N, 2H)
  float* d_nf;          // (N, H*D)
  float* d_w_ea;        // (E, H)
  int n_grid, n_nodes, n_edges, tn, te, k_src, H, D, self_loops;
  float slope;
};

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The per-head dot in the order of torch's sum over the last dimension on
// the card for D <= 64 (measured on the H100): rounded products, then
// halves, column c + column c ^ (D/2) first, down to c ^ 1. A lane holds
// four adjacent columns of the head's w lanes (w a power of two, segments
// aligned): column offsets >= 4 are shuffles at lane offset / 4, each
// column of the four on its own, and 2 and 1 are within the lane.
__device__ __forceinline__ float head_dot(float4 a, float4 b, int w) {
  float x = __fmul_rn(a.x, b.x), y = __fmul_rn(a.y, b.y),
        z = __fmul_rn(a.z, b.z), t = __fmul_rn(a.w, b.w);
  for (int o = w >> 1; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
    y = __fadd_rn(y, __shfl_xor_sync(kFull, y, o));
    z = __fadd_rn(z, __shfl_xor_sync(kFull, z, o));
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, o));
  }
  return __fadd_rn(__fadd_rn(x, z), __fadd_rn(y, t));
}

// d_zpre (returned) and p of one (dst, src) pair for the lane's head; zsrc =
// w_src + w_ea (w_src alone for a self-loop). Called by the whole warp.
__device__ __forceinline__ float pair_grad(float wdst, float zsrc, float m,
                                           float den, float s, float4 g,
                                           float4 x, int w, float slope,
                                           float& p) {
  const float zp = wdst + zsrc;
  p = expf(leaky(zp, slope) - m) / (den == 0.f ? 1.f : den);
  const float dp = head_dot(g, x, w);
  return p * (dp - s) * (zp > 0.f ? 1.f : slope);
}

// A block-wide compaction in thread order: the position of this thread's
// item among the block's kept ones (when keep), and how many were kept. The
// caller writes its item at the position, then calls __syncthreads() before
// reading the list.
__device__ __forceinline__ int compact(bool keep, int lane, int warp,
                                       int* st_count, int& pos) {
  const unsigned kept = __ballot_sync(kFull, keep);
  if (lane == 0) st_count[warp] = __popc(kept);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    const int c = st_count[w];
    off += w < warp ? c : 0;
    total += c;
  }
  pos = off + __popc(kept & ((1u << lane) - 1u));
  return total;
}

template <int NV>  // float4 column groups per lane: H*D <= 128 * NV
__global__ void __launch_bounds__(kThreads) tcsr_gat_bwd_kernel(
    const Args a, int n_dst_blocks) {
  __shared__ int st_row[kThreads];  // a staged edge's row in the slice
  __shared__ int st_oth[kThreads];  // its other end (src or dst)
  __shared__ int st_eid[kThreads];
  __shared__ int st_tile[kThreads];  // the source role's covering tiles
  __shared__ int st_count[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, HD = a.H * a.D, H2 = 2 * a.H, W = a.D >> 2;
  const int tn = a.tn;
  const float slope = a.slope;
  const int r0 = (a.t0 ? a.t0[0] : 0) * tn;  // absolute node of grid row 0
  const int n_rows = a.n_grid * tn;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  int col[NV], hd[NV];
  bool on[NV], first[NV];  // first: the head's first lane writes its scalars
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = 128 * v + 4 * lane;
    on[v] = col[v] < HD;
    hd[v] = on[v] ? col[v] / a.D : 0;
    first[v] = on[v] && col[v] % a.D == 0;
  }

  if ((int)blockIdx.x < n_dst_blocks) {
    // ---- destination role: d_wn[:, :H] and d_w_ea ------------------------
    const int slices = tn / kRows;
    const int t = blockIdx.x / slices;
    const int node0 = r0 + t * tn + (blockIdx.x % slices) * kRows;
    const int d = node0 + warp;                 // this warp's row
    const size_t dr = (size_t)(d - r0);         // its grid row
    const int e_lo = a.ew_blk[t] * a.te;
    const int e_hi = e_lo + a.cw[t] * a.te;
    float4 gi[NV];
    float wdst[NV], mi[NV], di[NV], si[NV], dacc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      gi[v] = on[v] ? ld4(a.g + dr * HD + col[v]) : zero4;
      wdst[v] = a.wn[(size_t)d * H2 + hd[v]];
      mi[v] = a.m[dr * H + hd[v]];
      di[v] = a.den[dr * H + hd[v]];
      si[v] = a.s[dr * H + hd[v]];
      dacc[v] = 0.f;
    }
    for (int base = e_lo; base < e_hi; base += kThreads) {
      // stage this round's edges of the slice, in edge order
      const int e = base + tid;
      int row = -1, sv = 0;
      if (e < e_hi) {
        const int dl = a.dst[e] - node0;
        if (dl >= 0 && dl < kRows && a.emask[e] > 0.f) {
          row = dl;
          sv = a.src[e];
        }
      }
      int pos;
      const int total = compact(row >= 0, lane, warp, st_count, pos);
      if (row >= 0) {
        st_row[pos] = row;
        st_oth[pos] = sv;
        st_eid[pos] = e;
      }
      __syncthreads();

      // this warp's edges of the round, kUnroll at a time
      for (int i0 = 0; i0 < total; i0 += 32) {
        const int i = i0 + lane;
        unsigned mine = __ballot_sync(kFull, i < total && st_row[i] == warp);
        while (mine) {
          int ss[kUnroll], ee[kUnroll];
          bool ok[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            ok[u] = mine != 0;
            const int b = ok[u] ? __ffs(mine) - 1 : 0;
            mine &= mine - 1;
            ss[u] = ok[u] ? st_oth[i0 + b] : 0;
            ee[u] = ok[u] ? st_eid[i0 + b] : 0;
          }
          float4 x[kUnroll][NV];
          float zs[kUnroll][NV];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              x[u][v] = ok[u] && on[v]
                  ? ld4(a.nf + (size_t)ss[u] * HD + col[v]) : zero4;
              zs[u][v] = ok[u] ? a.wn[(size_t)ss[u] * H2 + H + hd[v]]
                                 + a.w_ea[(size_t)ee[u] * H + hd[v]]
                               : 0.f;
            }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (!ok[u]) break;  // warp-uniform
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              float p;
              const float dz = pair_grad(wdst[v], zs[u][v], mi[v], di[v],
                                         si[v], gi[v], x[u][v], W, slope, p);
              dacc[v] += dz;
              if (first[v]) a.d_w_ea[(size_t)ee[u] * H + hd[v]] = dz;
            }
          }
        }
      }
      __syncthreads();  // the next round reuses the stage
    }
    if (a.self_loops) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 x = on[v] ? ld4(a.nf + (size_t)d * HD + col[v]) : zero4;
        float p;
        dacc[v] += pair_grad(wdst[v], a.wn[(size_t)d * H2 + H + hd[v]], mi[v],
                             di[v], si[v], gi[v], x, W, slope, p);
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (first[v]) a.d_wn[(size_t)d * H2 + hd[v]] = dacc[v];
    return;
  }

  // ---- source role: d_nf, d_wn[:, H:] ---------------------------------------
  const int b = blockIdx.x - n_dst_blocks;
  const int s0 = b * kRows;            // the slice's first node
  const int sn = s0 + warp;            // this warp's source row
  const int u_tile = s0 / tn;          // the slice's node tile

  // the masked edges' d_w_ea, in this block's share of the edge range
  const int n_src_blocks = a.n_nodes / kRows;
  const int per = (a.n_edges + n_src_blocks - 1) / n_src_blocks;
  const int z_hi = min(a.n_edges, (b + 1) * per);
  for (int e = b * per + tid; e < z_hi; e += kThreads)
    if (!(a.emask[e] > 0.f))
      for (int h = 0; h < H; ++h) a.d_w_ea[(size_t)e * H + h] = 0.f;

  float4 xs[NV], dnf[NV];
  float wsrc[NV], wself[NV], dws[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    xs[v] = on[v] ? ld4(a.nf + (size_t)sn * HD + col[v]) : zero4;
    wsrc[v] = a.wn[(size_t)sn * H2 + H + hd[v]];
    wself[v] = a.wn[(size_t)sn * H2 + hd[v]];
    dnf[v] = zero4;
    dws[v] = 0.f;
  }

  for (int tb = 0; tb < a.n_grid; tb += kThreads) {
    // the destination tiles whose source window holds the slice, in order
    const int tt = tb + tid;
    bool cover = false;
    if (tt < a.n_grid) {
      const int w0 = a.sw_tile[tt];
      cover = w0 <= u_tile && u_tile < w0 + a.k_src;
    }
    int pos;
    const int n_cov = compact(cover, lane, warp, st_count, pos);
    if (cover) st_tile[pos] = tt;
    __syncthreads();

    for (int k = 0; k < n_cov; ++k) {
      const int t = st_tile[k];
      const int dlo = r0 + t * tn;  // the tile's first node
      const int e_lo = a.ew_blk[t] * a.te;
      const int e_hi = e_lo + a.cw[t] * a.te;
      for (int base = e_lo; base < e_hi; base += kThreads) {
        // stage this round's edges from the slice into tile t, in order
        const int e = base + tid;
        int row = -1, dv = 0;
        if (e < e_hi) {
          const int sl = a.src[e] - s0;
          if (sl >= 0 && sl < kRows && a.emask[e] > 0.f) {
            dv = a.dst[e];
            if (dv >= dlo && dv < dlo + tn) row = sl;
          }
        }
        int pos2;
        const int total = compact(row >= 0, lane, warp, st_count, pos2);
        if (row >= 0) {
          st_row[pos2] = row;
          st_oth[pos2] = dv;
          st_eid[pos2] = e;
        }
        __syncthreads();

        for (int i0 = 0; i0 < total; i0 += 32) {
          const int i = i0 + lane;
          unsigned mine = __ballot_sync(kFull,
                                        i < total && st_row[i] == warp);
          while (mine) {
            int dd[kUnroll], ee[kUnroll];
            bool ok[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              ok[u] = mine != 0;
              const int bb = ok[u] ? __ffs(mine) - 1 : 0;
              mine &= mine - 1;
              dd[u] = ok[u] ? st_oth[i0 + bb] : r0;
              ee[u] = ok[u] ? st_eid[i0 + bb] : 0;
            }
            float4 gu[kUnroll][NV];
            float wdu[kUnroll][NV], mu[kUnroll][NV], du[kUnroll][NV],
                su[kUnroll][NV], zs[kUnroll][NV];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const size_t dr = (size_t)(dd[u] - r0);
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                gu[u][v] = ok[u] && on[v] ? ld4(a.g + dr * HD + col[v])
                                          : zero4;
                wdu[u][v] = ok[u] ? a.wn[(size_t)dd[u] * H2 + hd[v]] : 0.f;
                mu[u][v] = ok[u] ? a.m[dr * H + hd[v]] : 0.f;
                du[u][v] = ok[u] ? a.den[dr * H + hd[v]] : 1.f;
                su[u][v] = ok[u] ? a.s[dr * H + hd[v]] : 0.f;
                zs[u][v] = wsrc[v]
                    + (ok[u] ? a.w_ea[(size_t)ee[u] * H + hd[v]] : 0.f);
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (!ok[u]) break;  // warp-uniform
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                float p;
                dws[v] += pair_grad(wdu[u][v], zs[u][v], mu[u][v], du[u][v],
                                    su[u][v], gu[u][v], xs[v], W, slope, p);
                dnf[v].x += p * gu[u][v].x;
                dnf[v].y += p * gu[u][v].y;
                dnf[v].z += p * gu[u][v].z;
                dnf[v].w += p * gu[u][v].w;
              }
            }
          }
        }
        __syncthreads();  // the next round reuses the stage
      }
    }
  }

  const bool in_grid = sn >= r0 && sn < r0 + n_rows;
  if (a.self_loops && in_grid) {
    const size_t dr = (size_t)(sn - r0);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 gs = on[v] ? ld4(a.g + dr * HD + col[v]) : zero4;
      float p;
      dws[v] += pair_grad(wself[v], wsrc[v], a.m[dr * H + hd[v]],
                          a.den[dr * H + hd[v]], a.s[dr * H + hd[v]], gs,
                          xs[v], W, slope, p);
      dnf[v].x += p * gs.x;
      dnf[v].y += p * gs.y;
      dnf[v].z += p * gs.z;
      dnf[v].w += p * gs.w;
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!on[v]) continue;
    *reinterpret_cast<float4*>(a.d_nf + (size_t)sn * HD + col[v]) = dnf[v];
    if (first[v]) {
      a.d_wn[(size_t)sn * H2 + H + hd[v]] = dws[v];
      if (!in_grid) a.d_wn[(size_t)sn * H2 + hd[v]] = 0.f;
    }
  }
}

int launch(const Args& a, void* stream) {
  // lanes read nf and g in float4 and sum a head's D/4 lanes by shuffles:
  // D/4 a power of two up to 32, H*D <= 256; slices of kRows rows
  const int w = a.D / 4;
  if (a.H <= 0 || a.D % 4 || w < 1 || w > 32 || (w & (w - 1))
      || a.H * a.D > 256 || a.tn <= 0 || a.tn % kRows
      || a.n_nodes <= 0 || a.n_nodes % kRows || a.n_grid < 0
      || a.n_edges < 0 || a.te <= 0 || a.k_src < 1)
    return (int)cudaErrorInvalidValue;
  const int n_dst = a.n_grid * (a.tn / kRows);
  const int n_src = a.n_nodes / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.H * a.D <= 128)
    tcsr_gat_bwd_kernel<1><<<n_dst + n_src, kThreads, 0, st>>>(a, n_dst);
  else
    tcsr_gat_bwd_kernel<2><<<n_dst + n_src, kThreads, 0, st>>>(a, n_dst);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tcsr_gat_bwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* ew_blk, const void* cw,
    const void* sw_tile, const void* m, const void* den, const void* g,
    const void* s, void* d_wn, void* d_nf, void* d_w_ea, int n_tiles,
    int n_edges, int tn, int te, int k_src, int H, int D, int self_loops,
    float slope, void* stream) {
  const Args a = {(const float*)wn, (const float*)nf, (const float*)w_ea,
                  (const int*)src, (const int*)dst, (const float*)emask,
                  nullptr, (const int*)ew_blk, (const int*)cw,
                  (const int*)sw_tile, (const float*)m, (const float*)den,
                  (const float*)g, (const float*)s, (float*)d_wn,
                  (float*)d_nf, (float*)d_w_ea, n_tiles, n_tiles * tn,
                  n_edges, tn, te, k_src, H, D, self_loops, slope};
  return launch(a, stream);
}

// K3's backward: one shard's grid of n_grid tiles from tile *t0 (device);
// m, den, g, s hold the grid's n_grid * tn rows; the node arrays and the
// outputs d_wn, d_nf hold all n_nodes nodes, the edge arrays and d_w_ea the
// shard's n_edges edges.
extern "C" int tcsr_gat_ep_bwd(
    const void* wn, const void* nf, const void* w_ea, const void* src,
    const void* dst, const void* emask, const void* t0, const void* ew_blk,
    const void* cw, const void* sw_tile, const void* m, const void* den,
    const void* g, const void* s, void* d_wn, void* d_nf, void* d_w_ea,
    int n_grid, int n_nodes, int n_edges, int tn, int te, int k_src, int H,
    int D, float slope, void* stream) {
  const Args a = {(const float*)wn, (const float*)nf, (const float*)w_ea,
                  (const int*)src, (const int*)dst, (const float*)emask,
                  (const int*)t0, (const int*)ew_blk, (const int*)cw,
                  (const int*)sw_tile, (const float*)m, (const float*)den,
                  (const float*)g, (const float*)s, (float*)d_wn,
                  (float*)d_nf, (float*)d_w_ea, n_grid, n_nodes, n_edges,
                  tn, te, k_src, H, D, 0, slope};
  return launch(a, stream);
}

extern "C" const char* tcsr_gat_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* tcsr_gat_ep_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
