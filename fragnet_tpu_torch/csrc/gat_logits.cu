// The GAT logit terms for Hopper (sm_90a), summed in f64 registers.
//
// Replaces no TPU kernel: the JAX package forms these terms with plain XLA
// einsums (fragnet_tpu/ops/pallas_gat.py:471-479, dense_gat.py). The port
// summed them as f64 einsums (ops/gat_logits.py:logit_dot): an f64 copy of
// every row, a cuBLAS f64 GEMM whose output has 2 to 8 columns, and in the
// backward an f64 GEMM of the attention vector's gradient whose output is
// one tile and whose depth is every row, then casts of each row's gradient
// back. This kernel pair computes the same function from the rows as they
// are, with no copies.
//
// Function, for the attention vector a (H, 2D + Da) = [a_dst | a_ea | a_src]
// and up to two row sets in one launch:
//   node rows x (N, H, D):  wn[n, k*H + h] = sum_d x[n, h, d] * a_k[h, d],
//                           a_0 = a[:, :D] (dst), a_1 = a[:, D + Da:] (src)
//   edge rows x (E, Da):    w_ea[e, h]     = sum_c x[e, c] * a[h, D + c]
// Both are one shape: a row of S segments of L columns and K vectors per
// segment (node rows: S = H, L = D, K = 2; edge rows: S = 1, L = Da, K = H),
// out[r, k*S + s] = sum_l x[r, s*L + l] * vec(k, s)[l]. The backward:
//   d_x[r, s*L + l] = sum_k dw[r, k*S + s] * vec(k, s)[l]
//   d_vec(k, s)[l]  = sum_r dw[r, k*S + s] * x[r, s*L + l]
// Every product and every sum is formed in f64 (the product of two f32
// values is exact there) and each output is rounded once: to f32, or, for
// a bf16 d_x, to f32 and then to bf16 with ties to even, as torch's cast
// from f64 does. A logit's terms can cancel to within f32 round-off of the
// leaky ReLU's kink (an ea.a_ea dot of terms near 1 summing to 1e-2): an
// f32 sum lands on the side its order gives, a sum in f64 rounded once on
// the same side on every machine.
//
// What bounds it on this card: bytes. The forward reads each row once and
// writes K*S f32 a row; the backward reads each row and its K*S cotangents
// and writes the row's gradient, in the row's type. At the batch-4096
// pretraining step (A ~ 2.5e5 atoms, E ~ 5e5 bonds, ~1e6 bond-graph edges,
// rows of 128 f32) the forward reads ~0.9 GB a layer and the backward
// ~1.8 GB: ~1 ms a layer at 3.35 TB/s. The f64 arithmetic, ~1e9 FMAs a
// layer, and the f32 -> f64 conversions are well inside the SMs' rates.
//
// Design:
//   * A block of 256 threads takes TR rows at a time. A row is S * Qp
//     slots; a slot reads V adjacent columns of one segment in one load (16
//     bytes where L, the row stride and the base allow, else 8, 4 or 2; the
//     wrapper chooses V, ops/gat_logits.py:plan) and holds its K * V
//     attention values in f64 registers for the block's life: the block
//     walks every blocks-th tile of TR rows. Qp is L / V rounded up to a
//     power of two, the extra slots idle.
//   * A thread issues the loads of several of its tiles before it sums any
//     (kFwdTiles, kBwdTiles): the bytes in flight, not the arithmetic, set
//     the pace. Where every row set loads 4 values or more (f32 rows in 16
//     bytes, bf16 in 8 or 16), the launch takes a kernel of the sets'
//     element types alone (gat_logits_fwd_kernel<float, float> on the f32
//     path): the narrow loads' instances hold more vectors a slot and so
//     more registers, and the bf16 instances more loaded values, which
//     would cost the main path its occupancy.
//   * Forward: a slot's K partial dots meet the other slots of its segment
//     through a reduce-scatter butterfly of xor shuffles: each step gives
//     away half the sums a lane holds, so 32 slots with 4 vectors take 6
//     f64 shuffles and not 20; past one warp (Qp > 32) the warps' sums meet
//     in shared memory. Each output is written by one lane.
//   * Backward: a slot writes its V columns of d_x and adds dw * x into K*V
//     f64 sums over the block's rows; the block sums those over its TR row
//     positions in order through shared memory into one f64 partial of
//     d_vec, and gat_logits_dvec sums the blocks' partials (a warp an
//     element: each lane every 32nd block in order, then a fixed tree),
//     rounds once and writes d_vec in a's layout (H, 2D + Da), zeros where
//     no row set reads a. No atomics: the same inputs give the same bits.
//   * Node and edge rows share a launch: the first set[0].blocks blocks take
//     the node rows, the rest the edge rows.
//
// gat_logits_fwd_bf16 and gat_logits_bwd_bf16 are the same kernels where a
// row set is bf16 (widened to f32 on load, exactly); gat_logits_fwd and
// gat_logits_bwd take f32 rows only. Each entry has its own launch count.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef unsigned short bf16_bits;  // one bf16 value, as stored

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKV = 16;  // attention values (and d_vec sums) of a slot
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdTiles = 4;  // tiles whose loads a thread has in flight
constexpr int kBwdTiles = 2;

struct RowSet {
  const void* x;      // (R, stride) rows of S segments of L columns
  void* y;            // forward: out (R, K*S) f32; backward: d_x (R, S*L)
                      // in x's type
  const float* dw;    // backward: (R, K*S) f32
  long long R;        // rows; 0: the set is absent
  long long stride;   // x's row stride, elements
  long long part0;    // backward: the set's first partial (doubles)
  int S, L, K;
  int node;           // vec(k, s) = a[s, k ? D + Da : 0] (node rows) or
                      // a[k, D] (edge rows)
  int bf16;           // x (and d_x) in bf16, else f32
  int V;              // columns a slot loads
  int Qp;             // slots a segment
  int TR;             // rows a tile
  int blocks;         // the set's blocks
};

struct Params {
  RowSet set[2];      // node rows, edge rows
  const float* a;     // (H, 2D + Da), rows a_stride apart
  double* part;       // backward: the blocks' partials of d_vec
  float* dvec;        // (H, 2D + Da), contiguous
  long long a_stride;
  int H, D, Da;
};

__device__ __forceinline__ float widen(float v) { return v; }
// a bf16 is the high half of its f32
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float((unsigned)v << 16);
}

__device__ __forceinline__ void narrow(double d, float* p) {
  *p = __double2float_rn(d);
}
// as torch's cast from f64 to bf16: to f32, then to bf16 with ties to even
__device__ __forceinline__ void narrow(double d, bf16_bits* p) {
  const unsigned u = __float_as_uint(__double2float_rn(d));
  *p = (u & 0x7fffffffu) > 0x7f800000u
           ? (bf16_bits)0x7fc0u
           : (bf16_bits)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <int B> struct Raw;
template <> struct Raw<2> { typedef unsigned short t; };
template <> struct Raw<4> { typedef unsigned int t; };
template <> struct Raw<8> { typedef uint2 t; };
template <> struct Raw<16> { typedef uint4 t; };

// V adjacent values in one load of V * sizeof(T) bytes, widened to f32
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  typedef typename Raw<sizeof(T) * V>::t R;
  union { R raw; T v[V]; } u;
  u.raw = __ldg(reinterpret_cast<const R*>(p));
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = widen(u.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const double (&d)[V]) {
  typedef typename Raw<sizeof(T) * V>::t R;
  union { R raw; T v[V]; } u;
#pragma unroll
  for (int i = 0; i < V; ++i) narrow(d[i], &u.v[i]);
  *reinterpret_cast<R*>(p) = u.raw;
}

// a thread's slot: row position tr of the tile, segment seg, slot q of it
struct Slot {
  int tr, ci, seg, q;
  bool on;  // tr < TR and the slot reads columns
};

__device__ __forceinline__ Slot slot_of(const RowSet& st) {
  const int C = st.S * st.Qp;
  Slot s;
  s.tr = threadIdx.x / C;
  s.ci = threadIdx.x - s.tr * C;
  s.seg = s.ci / st.Qp;
  s.q = s.ci - s.seg * st.Qp;
  s.on = s.tr < st.TR && s.q * st.V < st.L;
  return s;
}

// the slot's attention values vec(k, seg)[q*V + v] in f64, 0 past K
template <int V, int KM>
__device__ __forceinline__ void load_a(const Params& P, const RowSet& st,
                                       const Slot& sl, double (&av)[KM][V]) {
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const long long row = st.node ? sl.seg : k;
    const int col = (st.node ? (k ? P.D + P.Da : 0) : P.D) + sl.q * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      av[k][v] = sl.on && k < st.K
                     ? (double)P.a[row * P.a_stride + col + v] : 0.0;
  }
}

// reduce-scatter over a segment's G slots of one warp, step J on: at step j
// a lane keeps half its sums (the upper half where bit j of its lane is set)
// and adds its partner's; once it holds one sum, the steps left add the
// partner's whole (every lane of a pair then holds the same). koff: the
// vector of acc[0]; cnt: the sums held.
template <int KM, int J>
__device__ __forceinline__ void butterfly(double (&acc)[KM], int G, int lane,
                                          int& koff, int& cnt) {
  if constexpr (J < 5) {
    constexpr int o = 1 << J;
    constexpr int half = (KM >> 1) >> J;
    if (o < G) {
      if constexpr (half >= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const double give = up ? acc[i] : acc[i + half];
          const double keep = up ? acc[i + half] : acc[i];
          acc[i] = keep + __shfl_xor_sync(kFull, give, o);
        }
        if (up) koff += half;
        cnt = half;
      } else {
        acc[0] += __shfl_xor_sync(kFull, acc[0], o);
      }
      butterfly<KM, J + 1>(acc, G, lane, koff, cnt);
    }
  }
}

// KM: the vectors a slot holds (K <= KM; 2 for node rows, whose K is 2)
template <typename T, int V, int KM>
__device__ __forceinline__ void fwd_rows(const Params& P, const RowSet& st,
                                         int lb, double* red) {
  const Slot sl = slot_of(st);
  double av[KM][V];
  load_a<V, KM>(P, st, sl, av);
  const T* x = static_cast<const T*>(st.x) + sl.seg * st.L + sl.q * V;
  float* out = static_cast<float*>(st.y);
  const int J = st.K * st.S;
  const int G = st.Qp < 32 ? st.Qp : 32;  // a segment's slots in one warp
  const int lane = threadIdx.x & 31;
  for (long long t0 = lb; t0 * st.TR < st.R; t0 += kFwdTiles * st.blocks) {
    // the loads of kFwdTiles tiles first, then their sums
    float f[kFwdTiles][V];
#pragma unroll
    for (int u = 0; u < kFwdTiles; ++u) {
      const long long r = (t0 + (long long)u * st.blocks) * st.TR + sl.tr;
      if (sl.on && r < st.R) load<T, V>(x + r * st.stride, f[u]);
    }
#pragma unroll
    for (int u = 0; u < kFwdTiles; ++u) {
      const long long t = t0 + (long long)u * st.blocks;
      if (t * st.TR >= st.R) break;
      const long long r = t * st.TR + sl.tr;
      double acc[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k) acc[k] = 0.0;
      if (sl.on && r < st.R) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const double xv = f[u][v];
#pragma unroll
          for (int k = 0; k < KM; ++k)
            if (k < st.K) acc[k] = fma(xv, av[k][v], acc[k]);
        }
      }
      int koff = 0, cnt = KM;
      butterfly<KM, 0>(acc, G, lane, koff, cnt);
      const bool writer = (lane & (G - 1)) < KM;  // one lane of each pair
      if (st.Qp <= 32) {
        if (writer && sl.tr < st.TR && r < st.R) {
#pragma unroll
          for (int i = 0; i < KM; ++i)
            if (i < cnt && koff + i < st.K)
              out[r * J + (koff + i) * st.S + sl.seg] =
                  __double2float_rn(acc[i]);
        }
      } else {
        // a segment spans Qp / 32 whole warps: lane i < KM of each holds
        // vector i's sum over the warp; the segment's first K lanes add
        // the warps' sums in order
        const int w = threadIdx.x >> 5;
        if (writer) red[w * KM + koff] = acc[0];
        __syncthreads();
        if (sl.q < st.K && sl.tr < st.TR && r < st.R) {
          double s = 0.0;
          for (int i = 0; i < st.Qp / 32; ++i) s += red[(w + i) * KM + sl.q];
          out[r * J + sl.q * st.S + sl.seg] = __double2float_rn(s);
        }
        __syncthreads();
      }
    }
  }
}

template <typename T, int V, int KM>
__device__ __forceinline__ void bwd_rows(const Params& P, const RowSet& st,
                                         int lb, double* buf) {
  const Slot sl = slot_of(st);
  double av[KM][V];
  load_a<V, KM>(P, st, sl, av);
  double acc[KM][V];
#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.0;
  const int col = sl.seg * st.L + sl.q * V;
  const T* x = static_cast<const T*>(st.x) + col;
  T* dx = static_cast<T*>(st.y);
  const float* dw = st.dw + sl.seg;
  const int J = st.K * st.S;
  const int W = st.S * st.L;
  for (long long t0 = lb; t0 * st.TR < st.R; t0 += kBwdTiles * st.blocks) {
    // the loads of kBwdTiles rows first (their columns and cotangents),
    // then their sums
    float f[kBwdTiles][V], g[kBwdTiles][KM];
    bool live[kBwdTiles];
#pragma unroll
    for (int u = 0; u < kBwdTiles; ++u) {
      const long long r = (t0 + (long long)u * st.blocks) * st.TR + sl.tr;
      live[u] = sl.on && r < st.R;
      if (live[u]) {
        load<T, V>(x + r * st.stride, f[u]);
#pragma unroll
        for (int k = 0; k < KM; ++k)
          g[u][k] = k < st.K ? __ldg(dw + r * J + k * st.S) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdTiles; ++u) {
      if (!live[u]) continue;
      const long long r = (t0 + (long long)u * st.blocks) * st.TR + sl.tr;
      double d[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < KM; ++k)
          if (k < st.K) s = fma((double)g[u][k], av[k][v], s);
        d[v] = s;
      }
      store<T, V>(dx + r * W + col, d);
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < st.K) {
          const double gk = g[u][k];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[k][v] = fma(gk, (double)f[u][v], acc[k][v]);
        }
    }
  }
  // the block's sums over its row positions, in order
  for (int i = 0; i < st.TR; ++i) {
    if (sl.tr == i) {
#pragma unroll
      for (int k = 0; k < KM; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          double* p = buf + (sl.ci * KM + k) * V + v;
          *p = i ? *p + acc[k][v] : acc[k][v];
        }
    }
    __syncthreads();
  }
  double* part = P.part + st.part0 + (long long)lb * st.K * W;
  const int n = st.S * st.Qp * KM * V;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e / (KM * V);
    const int k = (e / V) % KM;
    const int v = e % V;
    const int seg = c / st.Qp;
    const int q = c - seg * st.Qp;
    if (k < st.K && q * V < st.L)
      part[(long long)k * W + seg * st.L + q * V + v] = buf[e];
  }
}

template <bool kBwd, typename T, int V, bool kNode>
__device__ __forceinline__ void body(const Params& P, const RowSet& st,
                                     int lb, double* sm) {
  constexpr int KM = kNode ? 2 : kMaxKV / V;
  if constexpr (kBwd)
    bwd_rows<T, V, KM>(P, st, lb, sm);
  else
    fwd_rows<T, V, KM>(P, st, lb, sm);
}

// the row set's instance: where every row set loads 4 values or more (f32
// in 16 bytes, bf16 in 8 or 16), a kernel of its element types (T = float
// or bf16_bits) holds only its own instances; otherwise (T = Any) every
// instance, whose narrow loads hold more vectors a slot and so more
// registers than the main path's should pay for
struct Any {};

template <bool kBwd, typename T, bool kNode>
__device__ __forceinline__ void rows(const Params& P, const RowSet& st,
                                     int lb, double* sm) {
  if constexpr (std::is_same<T, float>::value) {
    body<kBwd, float, 4, kNode>(P, st, lb, sm);
  } else if constexpr (std::is_same<T, bf16_bits>::value) {
    if (st.V == 8)
      body<kBwd, bf16_bits, 8, kNode>(P, st, lb, sm);
    else
      body<kBwd, bf16_bits, 4, kNode>(P, st, lb, sm);
  } else if (st.bf16) {
    switch (st.V) {
      case 8: body<kBwd, bf16_bits, 8, kNode>(P, st, lb, sm); break;
      case 4: body<kBwd, bf16_bits, 4, kNode>(P, st, lb, sm); break;
      case 2: body<kBwd, bf16_bits, 2, kNode>(P, st, lb, sm); break;
      default: body<kBwd, bf16_bits, 1, kNode>(P, st, lb, sm); break;
    }
  } else {
    switch (st.V) {
      case 4: body<kBwd, float, 4, kNode>(P, st, lb, sm); break;
      case 2: body<kBwd, float, 2, kNode>(P, st, lb, sm); break;
      default: body<kBwd, float, 1, kNode>(P, st, lb, sm); break;
    }
  }
}

// the first set[0].blocks blocks take the node rows (TN), the rest the
// edge rows (TE)
template <bool kBwd, typename TN, typename TE>
__device__ __forceinline__ void run(const Params& P, double* sm) {
  const int n0 = P.set[0].blocks;
  if ((int)blockIdx.x < n0)
    rows<kBwd, TN, true>(P, P.set[0], blockIdx.x, sm);
  else
    rows<kBwd, TE, false>(P, P.set[1], blockIdx.x - n0, sm);
}

template <typename TN, typename TE>
__global__ void __launch_bounds__(kThreads)
    gat_logits_fwd_kernel(const __grid_constant__ Params P) {
  __shared__ double red[kThreads / 32 * kMaxKV];
  run<false, TN, TE>(P, red);
}

template <typename TN, typename TE>
__global__ void __launch_bounds__(kThreads)
    gat_logits_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ double buf[];
  run<true, TN, TE>(P, buf);
}

// d_vec[h, col] in a's layout: the sum of the blocks' partials, a warp an
// element, each lane over every 32nd block in order, then the lanes in a
// fixed tree
__global__ void __launch_bounds__(kThreads)
    gat_logits_dvec_kernel(const __grid_constant__ Params P) {
  const int Wa = 2 * P.D + P.Da;
  const int idx = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= P.H * Wa) return;
  const int h = idx / Wa;
  const int col = idx - h * Wa;
  const bool edge = col >= P.D && col < P.D + P.Da;
  const RowSet st = edge ? P.set[1] : P.set[0];
  int k, s, l;
  if (edge) {
    k = h, s = 0, l = col - P.D;
  } else {
    k = col >= P.D + P.Da, s = h, l = k ? col - P.D - P.Da : col;
  }
  double sum = 0.0;
  if (st.R > 0) {
    const long long KW = (long long)st.K * st.S * st.L;
    const double* p = P.part + st.part0 + (long long)k * st.S * st.L
                      + s * st.L + l;
    for (int b = lane; b < st.blocks; b += 32) sum += p[b * KW];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) P.dvec[idx] = __double2float_rn(sum);
}

// cfg (host, int64): H, D, Da, a_stride, then for the node and the edge
// rows: R, stride, part0, S, L, K, node, bf16, V, Qp, TR, blocks
constexpr int kCfgSet = 12;

bool valid_set(const RowSet& s) {
  if (s.R == 0) return true;
  const int vmax = s.bf16 ? 8 : 4;
  const int C = s.S * s.Qp;
  return s.V >= 1 && s.V <= vmax && (s.V & (s.V - 1)) == 0 &&
         s.L % s.V == 0 && s.K >= 1 && s.K * s.V <= kMaxKV &&
         (!s.node || s.K == 2) && s.Qp >= 1 &&
         (s.Qp & (s.Qp - 1)) == 0 && s.Qp * s.V >= s.L && C <= kThreads &&
         s.TR >= 1 && s.TR * C <= kThreads && s.blocks >= 1 &&
         (long long)s.blocks * s.TR < s.R + s.TR;
}

// the Params of cfg; false where the entry ("bf16": some row set in bf16,
// else none) or a set's plan is not one the kernels take
bool make_params(Params& P, const long long* cfg, bool bf16_entry) {
  P.H = (int)cfg[0];
  P.D = (int)cfg[1];
  P.Da = (int)cfg[2];
  P.a_stride = cfg[3];
  bool any_bf16 = false;
  for (int i = 0; i < 2; ++i) {
    const long long* c = cfg + 4 + i * kCfgSet;
    RowSet& s = P.set[i];
    s.R = c[0], s.stride = c[1], s.part0 = c[2];
    s.S = (int)c[3], s.L = (int)c[4], s.K = (int)c[5], s.node = (int)c[6];
    s.bf16 = (int)c[7], s.V = (int)c[8], s.Qp = (int)c[9], s.TR = (int)c[10];
    s.blocks = s.R > 0 ? (int)c[11] : 0;
    if (!valid_set(s)) return false;
    any_bf16 |= s.R > 0 && s.bf16;
  }
  return any_bf16 == bf16_entry;
}

// the kernel for P's row sets: of their element types where every present
// set loads 4 values or more, else the one of every instance
typedef void (*KernelFn)(Params);

template <bool kBwd>
KernelFn pick(const Params& P) {
  const bool wide = (P.set[0].R == 0 || P.set[0].V >= 4) &&
                    (P.set[1].R == 0 || P.set[1].V >= 4);
  const bool n16 = P.set[0].R > 0 && P.set[0].bf16;
  const bool e16 = P.set[1].R > 0 && P.set[1].bf16;
  if constexpr (kBwd) {
    if (!wide) return gat_logits_bwd_kernel<Any, Any>;
    if (n16) return e16 ? gat_logits_bwd_kernel<bf16_bits, bf16_bits>
                        : gat_logits_bwd_kernel<bf16_bits, float>;
    return e16 ? gat_logits_bwd_kernel<float, bf16_bits>
               : gat_logits_bwd_kernel<float, float>;
  } else {
    if (!wide) return gat_logits_fwd_kernel<Any, Any>;
    if (n16) return e16 ? gat_logits_fwd_kernel<bf16_bits, bf16_bits>
                        : gat_logits_fwd_kernel<bf16_bits, float>;
    return e16 ? gat_logits_fwd_kernel<float, bf16_bits>
               : gat_logits_fwd_kernel<float, float>;
  }
}

int launch_fwd(const void* a, const void* xn, void* outn, const void* xe,
               void* oute, const long long* cfg, void* stream,
               bool bf16_entry) {
  Params P = {};
  if (!make_params(P, cfg, bf16_entry)) return (int)cudaErrorInvalidValue;
  P.a = (const float*)a;
  P.set[0].x = xn, P.set[0].y = outn;
  P.set[1].x = xe, P.set[1].y = oute;
  const int grid = P.set[0].blocks + P.set[1].blocks;
  if (grid == 0) return (int)cudaSuccess;
  void* args[] = {&P};
  return (int)cudaLaunchKernel((const void*)pick<false>(P), dim3(grid),
                               dim3(kThreads), args, 0, (cudaStream_t)stream);
}

int launch_bwd(const void* a, const void* xn, void* dxn, const void* dwn,
               const void* xe, void* dxe, const void* dwe, void* part,
               const long long* cfg, void* stream, bool bf16_entry) {
  Params P = {};
  if (!make_params(P, cfg, bf16_entry)) return (int)cudaErrorInvalidValue;
  P.a = (const float*)a;
  P.part = (double*)part;
  P.set[0].x = xn, P.set[0].y = dxn, P.set[0].dw = (const float*)dwn;
  P.set[1].x = xe, P.set[1].y = dxe, P.set[1].dw = (const float*)dwe;
  size_t smem = 0;
  for (int i = 0; i < 2; ++i)
    if (P.set[i].R > 0) {
      const size_t n = (size_t)P.set[i].S * P.set[i].Qp * kMaxKV;
      smem = n * sizeof(double) > smem ? n * sizeof(double) : smem;
    }
  const int grid = P.set[0].blocks + P.set[1].blocks;
  if (grid == 0) return (int)cudaSuccess;
  void* args[] = {&P};
  return (int)cudaLaunchKernel((const void*)pick<true>(P), dim3(grid),
                               dim3(kThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace

// forward: out = x . a per row set; f32 rows only
extern "C" int gat_logits_fwd(const void* a, const void* xn, void* outn,
                              const void* xe, void* oute,
                              const long long* cfg, void* stream) {
  return launch_fwd(a, xn, outn, xe, oute, cfg, stream, false);
}

// forward where a row set is bf16
extern "C" int gat_logits_fwd_bf16(const void* a, const void* xn, void* outn,
                                   const void* xe, void* oute,
                                   const long long* cfg, void* stream) {
  return launch_fwd(a, xn, outn, xe, oute, cfg, stream, true);
}

// backward: d_x and each block's f64 partial of d_vec; f32 rows only
extern "C" int gat_logits_bwd(const void* a, const void* xn, void* dxn,
                              const void* dwn, const void* xe, void* dxe,
                              const void* dwe, void* part,
                              const long long* cfg, void* stream) {
  return launch_bwd(a, xn, dxn, dwn, xe, dxe, dwe, part, cfg, stream, false);
}

// backward where a row set is bf16
extern "C" int gat_logits_bwd_bf16(const void* a, const void* xn, void* dxn,
                                   const void* dwn, const void* xe, void* dxe,
                                   const void* dwe, void* part,
                                   const long long* cfg, void* stream) {
  return launch_bwd(a, xn, dxn, dwn, xe, dxe, dwe, part, cfg, stream, true);
}

// d_vec (H, 2D + Da) f32 from the backward's partials, either entry's
extern "C" int gat_logits_dvec(const void* part, void* dvec,
                               const long long* cfg, void* stream) {
  Params P = {};
  bool ok = false;
  for (int e = 0; e < 2 && !ok; ++e) ok = make_params(P, cfg, e == 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  P.part = (double*)part;
  P.dvec = (float*)dvec;
  const int n = P.H * (2 * P.D + P.Da);
  if (n == 0) return (int)cudaSuccess;
  constexpr int kWarps = kThreads / 32;
  gat_logits_dvec_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0,
                           (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* gat_logits_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* gat_logits_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* gat_logits_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* gat_logits_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* gat_logits_dvec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
