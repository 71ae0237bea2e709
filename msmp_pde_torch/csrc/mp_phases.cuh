// The message-passing layer over the whole batch at once, as a sequence of
// phases of one persistent cooperative kernel: the forward and the backward
// of the single layer (mp_layer_fwd.cu, mp_layer_bwd.cu; NL = 1) and of the
// gated pair (mp_pair_fwd.cu, mp_pair_bwd.cu; NL = 2: the gate layer, then
// the main layer, and the combine).
//
// Every phase cuts its work into items that do not depend on the grid: tiles
// of 32 x 64 outputs of a product, (graph, 16 features) of the InstanceNorm,
// elements of an elementwise pass. Block b takes items b, b + gridDim.x, ...
// of the phase's list, and cooperative_groups::this_grid().sync() separates
// the phases, so a phase reads what every block wrote in the ones before.
// Nothing is summed with atomics and every sum runs in an order fixed by the
// shapes: the results are bitwise the same from run to run, whatever the
// grid and the number of SMs.
//
// Rows are global over the batch: node row r = b nx + i, edge row
// e = r K + k with neighbour row nbr[e] = b nx + idx[i, k]. Phases, each
// over all the layers at once. A-D are the layers' forward, one copy that
// both directions run (forward_phases):
//   A   nbr[]; s_i = [h u px v] [w_hi; w_du; w_dx; w_v] + b1,
//       s_j = [h u px v] [w_hj; -w_du; -w_dx; 0]; the backward also
//       writes the transposed weights w4^T, w3[:2H]^T, w2^T, [w_hi; w_hj]^T
//   A2  m0 = s_i[r] + s_j[nbr[e]]                           (edges, gather)
//   B   z2 = swish(m0) w2 + b2                                       (edges)
//   B2  agg = sum_k mask swish(z2) / max(deg, 1)
//   C   z3 = [h, agg, v] w3 + b3
//   D   z4 = swish(z3) w4 + b4
// The forward ends with
//   E   InstanceNorm per (graph, feature) into out: the single layer's
//       norm([h +] [swish](z4)); the pair's gn and ln (written to the stash
//       too with STASH) and (1 - sigmoid(gn)) h + sigmoid(gn) swish(ln)
// and the backward goes on with
//   E   InstanceNorm forward and backward per (graph, feature), with the
//       pair's combine between them: dz4 and the first term of dh
//   F   dz3 = dz4 w4^T * swish'(z3);  dw4 = swish(z3)^T dz4, db4
//   G   [dh3 | dagg] = dz3 w3[:2H]^T, whose store writes
//       dz2[r K + k] = dagg[r] mask/deg swish'(z2);  dw3 = [h,agg,v]^T dz3, db3
//   H   dm0 = dz2 w2^T * swish'(m0) (over z2);  dw2 = swish(m0)^T dz2, db2
//   I   ds_i[r] = sum_k dm0[r K + k],
//       ds_j[n] = sum over the inverse list of n of mask dm0       (gathers)
//   J   dh += dh3 + [ds_i ds_j] [w_hi; w_hj]^T (the pair: into each layer's
//       dh3); [dw_hi dw_hj] = h^T [ds_i ds_j], db1;
//       [dw_du; dw_dx] = [u px]^T (ds_i - ds_j); dw_v = v^T ds_i
//   K   dw = the sum of the weight gradients' chunk partials, in chunk
//       order; the pair: dh += dh3 of the gate, then of the main layer
// A weight gradient X^T dY sums over all B nx node rows (or their edge rows):
// the rows are cut into chunks of CHUNK nodes (CHUNK_E nodes' edges), each
// (chunk, output tile) is an item that writes its own partial, and phase K
// sums the chunks. A bias gradient, a column sum of dY, comes with the
// weight tile whose rows start at 0, from the dY tiles in shared memory.
//
// Precision modes (the template parameter MM, bf16_mma.cuh): in the bf16
// modes every product rounds both operands to bf16 and sums their exact
// products in float32, as the TPU kernel's _dot / _dot_t (mp_pallas.py:
// 84-100). A tile rounds its A operand when it writes it to shared memory
// (after post(), so a swish rounds after it is taken) and its W operand when
// it reads it for a product, so that a bias gradient sums the unrounded dY.
// The edge products run on bf16 mma.sync instead of 3xTF32. The TPU
// kernel's products with its one-hot and 1/deg matrices are gathers and sums
// here, each with the rounding of its operands written out:
//   A2  m0 = bf16(s_i[r]) + bf16(s_j[nbr])                   (E s_i + G s_j)
//   B2  agg = sum_k bf16(mask / deg) bf16(swish(z2))                  (A m2)
//   G   dz2 = bf16(dagg) bf16(mask / deg) swish'(z2)                (A^T dagg)
//   I   ds_i = sum_k bf16(dm0), ds_j = sum mask bf16(dm0)   (E^T dm0, G^T dm0)
//   J   [dw_du; dw_dx] from bf16(ds_i - ds_j), the W operand's rounding
// Everything else (biases, swish and its derivative, the InstanceNorm, the
// combine, the chunk sums) stays float32. The storage mode reads h, u, px,
// v and the weight matrices as bf16, so a term that adds h (the residual,
// the pair's combine and its backward) takes the rounded h.
#pragma once
#include <cooperative_groups.h>

#include <cstdint>

#include "mp_layer.cuh"
#include "tf32_mma.cuh"

namespace mp {
namespace phases {

namespace cg = cooperative_groups;

constexpr int PT = 256;          // threads a block
constexpr int PK = 16;           // depth of a tile's k-step
constexpr int TM = 32, TN = 64;  // output tile of every product
constexpr int AP = TM + 4;       // pitch of the A tile's rows
constexpr int WP = TN + 8;       // pitch of the W tile's rows
constexpr int CHUNK = 128;       // node rows of a node-gradient chunk
constexpr int CHUNK_E = 32;      // nodes whose edges make an edge chunk
constexpr int NF = 16;           // features of an InstanceNorm item
constexpr int RG = PT / NF;      // its row groups
// two buffers of a tile's A and W operands
constexpr int SMEM_FLOATS = 2 * PK * (AP + WP);
static_assert(SMEM_FLOATS >= 4 * PT, "phase E's sums need 4 PT floats");
// the edge products (z2, dm0 and dw2, half of the operations) on the tensor
// cores: 3xTF32 in float32, one bf16 pass in the bf16 modes
constexpr bool EDGE_TC = true;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

#ifdef MP_PHASE_TIMES
// Built with -DMP_PHASE_TIMES (msmp_pde_torch/tools/bwd_phases.py), block 0
// notes the card's clock at each phase boundary: g_phase_ns[0] at the start,
// g_phase_ns[n] once phase n (A = 1, A2 = 2, ..., E = 7, ..., K = 13) has
// ended; the forward's last phase is E.
__device__ unsigned long long g_phase_ns[16];
constexpr bool PHASE_TIMES = true;
#else
constexpr bool PHASE_TIMES = false;
#endif

// The grid-wide barrier that ends phase n.
__device__ __forceinline__ void phase_end(cg::grid_group& grid, int n) {
  grid.sync();
#ifdef MP_PHASE_TIMES
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phase_ns[n] = t;
  }
#endif
}

// Offsets of the 12 gradients in one layer's slice, in the 12-tuple order.
struct GradOff {
  int hi, hj, du, dx, v, b1, w2, b2, w3, b3, w4, b4, total;
  __host__ __device__ GradOff(int H, int D, int V) {
    hi = 0; hj = hi + H * H; du = hj + H * H; dx = du + D * H;
    v = dx + H; b1 = v + V * H; w2 = b1 + H; b2 = w2 + H * H;
    w3 = b2 + H; b3 = w3 + (2 * H + V) * H; w4 = b3 + H; b4 = w4 + H * H;
    total = b4 + H;
  }
};

template <int MM>  // the precision mode
struct Params {
  using T = In<MM>;         // the inputs' and weight matrices' type
  const T *h, *u, *px, *v;  // [R, H], [R, D], [R], [R, V]
  const int* idx;           // [nx, K]
  const float* mask;        // [nx, K]
  const int *rev_ptr, *rev_e;  // inverse neighbour list (ops/mp_layer.py)
  LayerW<T> w[2];              // the pair: gate, main
  const float* g;              // [R, H], the output cotangent
  float *dh, *dw, *scratch;    // [R, H], NL x 12 gradients, workspace
  int B, nx, H, D, V, K;
  float *out, *gn, *ln;  // the forward's [R, H] output; the pair's stash
};

// The Params of mode MM from the entry points' untyped input pointers.
template <int MM>
inline Params<MM> params(const void* h, const void* u, const void* px,
                         const void* v, const int* idx, const float* mask,
                         const int* rev_ptr, const int* rev_e,
                         const void* const* w0, const void* const* w1,
                         const float* g, float* dh, float* dw,
                         float* scratch, int B, int nx, int H, int D, int V,
                         int K, float* out, float* gn, float* ln) {
  using T = In<MM>;
  auto in = [](const void* x) { return static_cast<const T*>(x); };
  return Params<MM>{in(h), in(u), in(px), in(v), idx, mask, rev_ptr, rev_e,
                    {unpack<T>(w0), unpack<T>(w1)}, g, dh, dw, scratch,
                    B, nx, H, D, V, K, out, gn, ln};
}

// f(std::integral_constant<int, MM>) for the mode mm; an unknown mode is an
// invalid value and runs nothing.
template <class F>
inline int with_mode(int mm, const F& f) {
  switch (mm) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's workspace: per layer s_i, s_j, agg, z3, z4 [R, H] and m0,
// z2 [E, H]; then nbr [E] (ints). The backward's adds per layer dz4, dz3,
// ds_i, ds_j [R, H], dz2 [E, H], dh3 [R, H] and the 6 H^2 transposed
// weights; then the node-gradient partials, the edge-gradient partials and
// nbr.
__host__ __device__ inline long fwd_layer_floats(int R, int H, int K) {
  return 5L * R * H + 2L * R * K * H;
}
__host__ __device__ inline long fwd_scratch_floats(int NL, int B, int nx,
                                                   int H, int K) {
  const int R = B * nx;
  return NL * fwd_layer_floats(R, H, K) + (long)R * K;
}
__host__ __device__ inline long layer_floats(int R, int H, int K) {
  return fwd_layer_floats(R, H, K) + 5L * R * H + (long)R * K * H +
         6L * H * H;
}
__host__ __device__ inline long scratch_floats(int NL, int B, int nx, int H,
                                               int D, int V, int K) {
  const int R = B * nx;
  return NL * layer_floats(R, H, K) +
         (long)cdiv(R, CHUNK) * NL * GradOff(H, D, V).total +
         (long)cdiv(R, CHUNK_E) * NL * (H * H + H) + (long)R * K;
}

struct Lay {  // one layer's buffers; dm0 overwrites z2
  float *si, *sj, *agg, *z3, *z4, *m0, *z2;       // the forward's
  float *dz4, *dz3, *dsi, *dsj, *dz2, *dh3;       // the backward's
  float *t4, *t3, *t2, *thj;  // w4^T, w3[:2H]^T [H, 2H], w2^T, [w_hi; w_hj]^T
};

// Layer l's buffers in the workspace, each layer `per` floats: the
// forward's first, so that its workspace is a prefix of each layer's slice.
__device__ inline Lay layer_bufs(float* scratch, int l, long per, int R,
                                 int H, int K) {
  const long RH = (long)R * H, EH = RH * K;
  float* b = scratch + l * per;
  Lay L;
  L.si = b;
  L.sj = b + RH;
  L.agg = b + 2 * RH;
  L.z3 = b + 3 * RH;
  L.z4 = b + 4 * RH;
  L.m0 = b + 5 * RH;
  L.z2 = L.m0 + EH;
  L.dz4 = L.z2 + EH;
  L.dz3 = L.dz4 + RH;
  L.dsi = L.dz3 + RH;
  L.dsj = L.dsi + RH;
  L.dz2 = L.dsj + RH;
  L.dh3 = L.dz2 + EH;
  L.t4 = L.dh3 + RH;
  L.t3 = L.t4 + H * H;
  L.t2 = L.t3 + 2 * H * H;
  L.thj = L.t2 + H * H;
  return L;
}

// ---- operand loaders (A(m, k), W(k, n)) and stores (S(m, n, acc)) -------
// A loader returns what it reads; post(loader, x) is the transform the tile
// applies when it writes x into shared memory (the identity but for swish),
// so that a tile's loads for the next k-step are in flight during this one.
template <class F>
struct Tr {  // the transpose of a loader: (a, b) -> f(b, a)
  F f;
  __device__ float operator()(int a, int b) const { return f(b, a); }
};

struct Sw {  // swish of row-major pre-activations, applied by post()
  const float* z;
  int ld;
  __device__ float operator()(int r, int c) const { return z[r * ld + c]; }
};

template <class L>
__device__ __forceinline__ float post(const L&, float x) { return x; }
__device__ __forceinline__ float post(const Sw&, float x) { return swish(x); }
__device__ __forceinline__ float post(const Tr<Sw>&, float x) {
  return swish(x);
}

template <class T>
struct SidesIn {  // row r of [h | u | px | v]
  const T *h, *u, *px, *v;
  int H, D, V;
  __device__ float operator()(int r, int k) const {
    if (k < H) return f32(h[r * H + k]);
    k -= H;
    if (k < D) return f32(u[r * D + k]);
    if (k == D) return f32(px[r]);
    return f32(v[r * V + k - D - 1]);
  }
};

template <class T>
struct SidesW {  // [w_hi; w_du; w_dx; w_v | w_hj; -w_du; -w_dx; 0]
  const T *w_hi, *w_hj, *w_du, *w_dx, *w_v;
  int H, D;
  __device__ float operator()(int k, int n) const {
    const bool j = n >= H;
    if (j) n -= H;
    if (k < H) return f32((j ? w_hj : w_hi)[k * H + n]);
    k -= H;
    if (k > D) return j ? 0.0f : f32(w_v[(k - D - 1) * H + n]);
    const float x = f32(k < D ? w_du[k * H + n] : w_dx[n]);
    return j ? -x : x;
  }
};

struct Diff {  // ds_i - ds_j
  const float *a, *b;
  int H;
  __device__ float operator()(int k, int n) const {
    return a[k * H + n] - b[k * H + n];
  }
};

struct Cat2 {  // row r of [a | b], each [., H]
  const float *a, *b;
  int H;
  __device__ float operator()(int r, int c) const {
    return c < H ? a[r * H + c] : b[r * H + c - H];
  }
};

struct Store {  // out[m, n] = acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] = acc;
  }
};

struct StoreAdd {  // out[m, n] += acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] += acc;
  }
};

struct StoreAdd2 {  // out[m, n] += b[m, n] + acc
  float* out;
  const float* b;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] += b[m * ld + n] + acc;
  }
};

struct StoreDeriv {  // out[m, n] = acc * swish'(z[m, n])
  float* out;
  const float* z;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] = acc * dswish(z[m * ld + n]);
  }
};

// [dh3 | dagg][r, n]: dh3 kept; dagg -> dz2[r K + k, n] for every k, in
// the bf16 modes (RND) from the rounded dagg and mask / deg
template <bool RND>
struct StoreDh3Dz2 {
  float *dh3, *dz2;
  const float *z2, *mask;
  int H, K, nx;
  __device__ void operator()(int r, int n, float acc) const {
    if (n < H) {
      dh3[r * H + n] = acc;
      return;
    }
    n -= H;
    const float* m = mask + (r % nx) * K;
    float deg = 0.0f;
    for (int k = 0; k < K; ++k) deg += m[k];
    deg = fmaxf(deg, 1.0f);
    for (int k = 0; k < K; ++k) {
      const int q = (r * K + k) * H + n;
      if constexpr (RND)
        dz2[q] = bf16r(acc) * bf16r(m[k] / deg) * dswish(z2[q]);
      else
        dz2[q] = acc * (m[k] / deg) * dswish(z2[q]);
    }
  }
};

struct StoreSplit {  // columns [0, H) into a, [H, 2H) into b, each [., H]
  float *a, *b;
  int H;
  __device__ void operator()(int m, int n, float acc) const {
    if (n < H) a[m * H + n] = acc;
    else b[m * H + n - H] = acc;
  }
};

struct NoCol {  // no column sum
  static constexpr bool on = false;
  __device__ void operator()(int, float) const {}
};

struct Col {  // column sums of the W operand, columns [0, n) into out
  static constexpr bool on = true;
  float* out;
  int n;
  __device__ void operator()(int c, float s) const {
    if (c < n) out[c] = s;
  }
};

// One 32 x 64 output tile of C = A @ W over rows [m0, m0 + TM) of M and
// columns [n0, n0 + TN) of N, with the sum over k in [k0, k1) in steps of
// PK. The operands go through two buffers of shared memory: each thread's
// loads of the next k-step are in flight while the block multiplies this
// one, and one barrier a step separates them. With TC the products run on
// the tensor cores in 3xTF32 (each warp a 16 x 16 block, two m16n8k8 tiles
// a k8-step), else as plain FMAs (each thread 2 x 4 outputs). Either way a
// result is bitwise the same from run to run. With A_BY_M the A tile loads
// with consecutive threads on consecutive m (the transposed operand of a
// weight gradient). With Col on, the tile at m0 = 0 also sums the W
// operand's columns over [k0, k1) (a bias gradient), in k order. With RND
// (the bf16 modes) both operands round to bf16: A as it is written to shared
// memory, W as it is read, so the column sums take the unrounded W; with TC
// the products run on bf16 m16n8k16 tiles, one a warp's 8 columns and
// k-step.
template <bool A_BY_M, bool TC, bool RND, class ALoad, class WLoad,
          class StoreF, class ColF = NoCol>
__device__ void tile(int m0, int n0, int M, int N, int k0, int k1,
                     const ALoad& A, const WLoad& W, const StoreF& S,
                     float* smem, const ColF& C = ColF{}) {
  constexpr int RM = TM / 16, RN = TN / 16;
  constexpr int NA = TM * PK / PT, NW = PK * TN / PT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // TC: warp (wm, wn) owns rows wm*16 + [0, 16), columns wn*16 + [0, 16);
  // lane (g, t) = (lane / 4, lane % 4) as in the m16n8k8 fragments
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (tid / 32) % 2, wn = tid / 64;
  float ra[NA], rw[NW];  // this thread's loads of a k-step
  auto fetch = [&](int kb) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * PT;
      const int gm = m0 + (A_BY_M ? e % TM : e / PK);
      const int gk = kb + (A_BY_M ? e / TM : e % PK);
      ra[i] = (gm < M && gk < k1) ? A(gm, gk) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int e = tid + i * PT;
      const int gk = kb + e / TN, gn = n0 + e % TN;
      rw[i] = (gk < k1 && gn < N) ? W(gk, gn) : 0.0f;
    }
  };
  auto put = [&](int buf) {
    float(*As)[AP] = reinterpret_cast<float(*)[AP]>(smem + buf * PK * AP);
    float(*Ws)[WP] =
        reinterpret_cast<float(*)[WP]>(smem + 2 * PK * AP + buf * PK * WP);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * PT;
      const float x = post(A, ra[i]);
      As[A_BY_M ? e / TM : e % PK][A_BY_M ? e % TM : e / PK] =
          RND ? bf16r(x) : x;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int e = tid + i * PT;
      Ws[e / TN][e % TN] = rw[i];
    }
  };
  float acc[RM][RN] = {};
  float cs = 0.0f;     // TC: the column sum of column tid < TN
  float csr[RN] = {};  // FMA: the column sums of this thread's columns
  fetch(k0);
  put(0);
  __syncthreads();
  int buf = 0;
  for (int kb = k0; kb < k1; kb += PK, buf ^= 1) {
    const bool more = kb + PK < k1;
    if (more) fetch(kb + PK);
    const float(*As)[AP] =
        reinterpret_cast<const float(*)[AP]>(smem + buf * PK * AP);
    const float(*Ws)[WP] = reinterpret_cast<const float(*)[WP]>(
        smem + 2 * PK * AP + buf * PK * WP);
    if constexpr (TC && RND) {
      // the m16n8k16 fragments: A rows r, r + 8 at k 2t, 2t + 1 (and + 8);
      // B (column n) at k 2t, 2t + 1 (and + 8); As is k-major
      float(*d)[4] = reinterpret_cast<float(*)[4]>(&acc[0][0]);
      const int r = wm * 16 + g;
      const uint32_t a[4] = {pack_bf16(As[2 * t][r], As[2 * t + 1][r]),
                             pack_bf16(As[2 * t][r + 8], As[2 * t + 1][r + 8]),
                             pack_bf16(As[2 * t + 8][r], As[2 * t + 9][r]),
                             pack_bf16(As[2 * t + 8][r + 8],
                                       As[2 * t + 9][r + 8])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = wn * 16 + nt * 8 + g;
        const uint32_t b[2] = {pack_bf16(Ws[2 * t][n], Ws[2 * t + 1][n]),
                               pack_bf16(Ws[2 * t + 8][n], Ws[2 * t + 9][n])};
        mma_bf16(d[nt], a, b);
      }
      if (ColF::on && tid < TN)
#pragma unroll
        for (int k = 0; k < PK; ++k) cs += Ws[k][tid];
    } else if constexpr (TC) {
      float(*d)[4] = reinterpret_cast<float(*)[4]>(&acc[0][0]);
#pragma unroll
      for (int kk = 0; kk < PK; kk += 8) {
        uint32_t ab[4], as[4];
        const int r = wm * 16 + g;
        split_tf32(As[kk + t][r], ab[0], as[0]);
        split_tf32(As[kk + t][r + 8], ab[1], as[1]);
        split_tf32(As[kk + t + 4][r], ab[2], as[2]);
        split_tf32(As[kk + t + 4][r + 8], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = wn * 16 + nt * 8 + g;
          uint32_t bb[2], bs[2];
          split_tf32(Ws[kk + t][n], bb[0], bs[0]);
          split_tf32(Ws[kk + t + 4][n], bb[1], bs[1]);
          mma_tf32(d[nt], as, bb);
          mma_tf32(d[nt], ab, bs);
          mma_tf32(d[nt], ab, bb);
        }
      }
      if (ColF::on && tid < TN)
#pragma unroll
        for (int k = 0; k < PK; ++k) cs += Ws[k][tid];
    } else {
#pragma unroll
      for (int k = 0; k < PK; ++k) {
        float a[RM], w[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[k][ty * RM + i];
#pragma unroll
        for (int j = 0; j < RN; ++j) w[j] = Ws[k][tx * RN + j];
        if (ColF::on)
#pragma unroll
          for (int j = 0; j < RN; ++j) csr[j] += w[j];
        if constexpr (RND)
#pragma unroll
          for (int j = 0; j < RN; ++j) w[j] = bf16r(w[j]);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    if (more) put(buf ^ 1);
    __syncthreads();
  }
  if constexpr (TC) {
    // d[nt] = acc[nt / 2][2 (nt % 2) ..]: rows g, g + 8; columns 2t, 2t + 1
    const float* d = &acc[0][0];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gm = m0 + wm * 16 + g + (q / 2) * 8;
        const int gn = n0 + wn * 16 + nt * 8 + 2 * t + q % 2;
        if (gm < M && gn < N) S(gm, gn, d[nt * 4 + q]);
      }
    if (ColF::on && m0 == 0 && tid < TN && n0 + tid < N) C(n0 + tid, cs);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gm = m0 + ty * RM + i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gn = n0 + tx * RN + j;
        if (gn < N) S(gm, gn, acc[i][j]);
      }
    }
    if (ColF::on && m0 == 0 && ty == 0)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gn = n0 + tx * RN + j;
        if (gn < N) C(gn, csr[j]);
      }
  }
}

// Runs f(q) for this block's items q of a job of n items that follows
// `base` items of the phase's earlier jobs; returns base + n.
template <class F>
__device__ int items(int base, int n, const F& f) {
  const int G = gridDim.x;
  for (int t = base + ((int)blockIdx.x - base % G + G) % G; t < base + n;
       t += G)
    f(t - base);
  return base + n;
}

// The tiles of an M x N product over rows [0, M): n items from `base`;
// RND rounds the operands to bf16.
template <bool RND, bool TC = false, class ALoad, class WLoad, class StoreF>
__device__ int product(int base, int M, int N, int Kd, const ALoad& A,
                       const WLoad& W, const StoreF& S, float* smem) {
  const int tn = cdiv(N, TN);
  return items(base, cdiv(M, TM) * tn, [&](int q) {
    tile<false, TC, RND>((q / tn) * TM, (q % tn) * TN, M, N, 0, Kd, A, W, S,
                         smem);
  });
}

// The chunk partials of a weight gradient X^T dY ([M, N]) over `rows` data
// rows, chunks of `per` rows; out(c) is chunk c's partial slice, col(c) its
// bias column sums (NoCol for none).
template <bool RND, bool TC = false, class ALoad, class WLoad, class StoreAt,
          class ColAt>
__device__ int grad(int base, int M, int N, int rows, int per,
                    const ALoad& A, const WLoad& W, const StoreAt& out,
                    const ColAt& col, float* smem) {
  const int tm = cdiv(M, TM), tn = cdiv(N, TN), nch = cdiv(rows, per);
  return items(base, nch * tm * tn, [&](int q) {
    const int c = q / (tm * tn), t = q % (tm * tn);
    const int k0 = c * per, k1 = min(rows, k0 + per);
    tile<true, TC, RND>((t / tn) * TM, (t % tn) * TN, M, N, k0, k1, A, W,
                        out(c), smem, col(c));
  });
}

// The sum over a block's RG row groups of each thread's x[v], v < NV, for
// the block's NF features (thread t: feature t % NF); every thread of a
// feature gets the same sums, in the same order.
template <int NV>
__device__ void sum_groups(float (&x)[NV], float* red) {
#pragma unroll
  for (int v = 0; v < NV; ++v) red[v * PT + threadIdx.x] = x[v];
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = 0.0f;
    for (int gr = 0; gr < RG; ++gr)
      s += red[v * PT + gr * NF + threadIdx.x % NF];
    x[v] = s;
  }
  __syncthreads();
}

// The layers' pre-norm outputs x(l, q): the single layer's
// [h +] [swish](z4), the pair's z4 of the gate (l = 0) and the main layer.
template <int NL, bool FA, bool RES, class T>
struct PreNorm {
  const T* h;
  const float* z4[NL];
  __device__ float operator()(int l, int q) const {
    if constexpr (NL == 2) {
      return z4[l][q];
    } else {
      const float a = FA ? swish(z4[0][q]) : z4[0][q];
      return RES ? f32(h[q]) + a : a;
    }
  }
};

// Phase E's items (graph b, NF features): f(q0, rows, rg, mean, rs) for
// this block's items, with thread t on feature c = t % NF (q0 = b nx H + c)
// and rows rg = t / NF, rg + RG, ... of the rows < `rows`, and the
// InstanceNorm's mean and rsqrt factor of each layer's x for the feature,
// every thread of a feature with the same values, summed in an order fixed
// by the shapes.
template <int NL, class P, class X, class F>
__device__ __forceinline__ void norm_items(const P& p, const X& x,
                                           float* red, const F& f) {
  const int H = p.H, nx = p.nx, fch = cdiv(H, NF);
  const int rg = threadIdx.x / NF;
  const float fnx = (float)nx;
  for (int t = blockIdx.x; t < p.B * fch; t += gridDim.x) {
    const int c = (t % fch) * NF + threadIdx.x % NF;
    const int rows = c < H ? nx : 0;  // idle threads still reach the syncs
    const int q0 = (t / fch) * nx * H + c;
    float mean[NL], rs[NL], s[NL] = {};
    for (int i = rg; i < rows; i += RG)
#pragma unroll
      for (int l = 0; l < NL; ++l) s[l] += x(l, q0 + i * H);
    sum_groups(s, red);
#pragma unroll
    for (int l = 0; l < NL; ++l) mean[l] = s[l] / fnx;
    float v[NL] = {};
    for (int i = rg; i < rows; i += RG)
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const float d = x(l, q0 + i * H) - mean[l];
        v[l] += d * d;
      }
    sum_groups(v, red);
#pragma unroll
    for (int l = 0; l < NL; ++l) rs[l] = 1.0f / sqrtf(v[l] / fnx + 1e-5f);
    f(q0, rows, rg, mean, rs);
  }
}

// The forward's phase E: the single layer's out = norm(o); the pair's
// gn = norm(z4 of the gate), ln = norm(z4 of the main layer), written to
// the stash with STASH (the same values the combine reads, so out is
// bitwise the variant's without it), and out = (1 - sigmoid(gn)) h +
// sigmoid(gn) swish(ln).
template <int NL, bool FA, bool RES, bool STASH, int MM>
__device__ __forceinline__ void norm_fwd(const Params<MM>& p,
                                         const Lay (&L)[NL], float* red) {
  const int H = p.H;
  PreNorm<NL, FA, RES, In<MM>> x{p.h, {}};
#pragma unroll
  for (int l = 0; l < NL; ++l) x.z4[l] = L[l].z4;
  norm_items<NL>(p, x, red, [&](int q0, int rows, int rg, const float* mean,
                                const float* rs) {
    for (int i = rg; i < rows; i += RG) {
      const int q = q0 + i * H;
      if constexpr (NL == 1) {
        p.out[q] = (x(0, q) - mean[0]) * rs[0];
      } else {
        const float gn = (x(0, q) - mean[0]) * rs[0];
        const float ln = (x(1, q) - mean[1]) * rs[1];
        if constexpr (STASH) {
          p.gn[q] = gn;
          p.ln[q] = ln;
        }
        const float tau = sigm(gn);
        p.out[q] = (1.0f - tau) * f32(p.h[q]) + tau * swish(ln);
      }
    }
  });
}

// The backward's phase E. The single layer (NL = 1) normalizes o with
// rsqrt factor rs and takes g back through it: dxo = rs (g - mean(g) -
// xh mean(g xh)), dh = [dxo], dz4 = dxo [swish'(z4)]. The pair (NL = 2)
// normalizes gn and ln, takes g back through the combine
// (1 - sigmoid(gn)) h + sigmoid(gn) swish(ln), then each layer's norm.
template <int NL, bool FA, bool RES, int MM>
__device__ __forceinline__ void norm_bwd(const Params<MM>& p,
                                         const Lay (&L)[NL], float* red) {
  const int H = p.H;
  const float fnx = (float)p.nx;
  PreNorm<NL, FA, RES, In<MM>> x{p.h, {}};
#pragma unroll
  for (int l = 0; l < NL; ++l) x.z4[l] = L[l].z4;
  norm_items<NL>(p, x, red, [&](int q0, int rows, int rg, const float* mean,
                                const float* rs) {
    if constexpr (NL == 1) {
      float m[2] = {0.0f, 0.0f};
      for (int i = rg; i < rows; i += RG) {
        const int q = q0 + i * H;
        const float gq = p.g[q];
        m[0] += gq;
        m[1] += gq * ((x(0, q) - mean[0]) * rs[0]);
      }
      sum_groups(m, red);
      for (int i = rg; i < rows; i += RG) {
        const int q = q0 + i * H;
        const float xh = (x(0, q) - mean[0]) * rs[0];
        const float d = rs[0] * (p.g[q] - m[0] / fnx - xh * (m[1] / fnx));
        p.dh[q] = RES ? d : 0.0f;
        L[0].dz4[q] = FA ? d * dswish(L[0].z4[q]) : d;
      }
    } else {
      // per row: gn, ln, tau and the cotangents of ln and gn
      auto co = [&](int q, float& gn, float& ln, float& tau, float& dln,
                    float& dgn) {
        gn = (x(0, q) - mean[0]) * rs[0];
        ln = (x(1, q) - mean[1]) * rs[1];
        tau = sigm(gn);
        const float gq = p.g[q];
        dln = gq * tau * dswish(ln);
        dgn = gq * (swish(ln) - f32(p.h[q])) * tau * (1.0f - tau);
      };
      float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = rg; i < rows; i += RG) {
        float gn, ln, tau, dln, dgn;
        co(q0 + i * H, gn, ln, tau, dln, dgn);
        m[0] += dln;
        m[1] += dln * ln;
        m[2] += dgn;
        m[3] += dgn * gn;
      }
      sum_groups(m, red);
      for (int i = rg; i < rows; i += RG) {
        const int q = q0 + i * H;
        float gn, ln, tau, dln, dgn;
        co(q, gn, ln, tau, dln, dgn);
        L[1].dz4[q] = rs[1] * (dln - m[0] / fnx - ln * (m[1] / fnx));
        L[0].dz4[q] = rs[0] * (dgn - m[2] / fnx - gn * (m[3] / fnx));
        p.dh[q] = p.g[q] * (1.0f - tau);
      }
    }
  });
}

// Phases A-D, the layers' forward, into nbr and each layer's s_i, s_j, m0,
// z2, agg, z3 and z4; each phase ends with its grid-wide barrier.
template <int NL, int MM>
__device__ __forceinline__ void forward_phases(const Params<MM>& p,
                                               const Lay (&L)[NL], int* nbr,
                                               float* smem,
                                               cg::grid_group& grid) {
  using T = In<MM>;
  constexpr bool RND = MM != 0;
  const int nx = p.nx, H = p.H, D = p.D, V = p.V, K = p.K;
  const int R = p.B * nx, E = R * K, RH = R * H, EH = E * H;
  const int gthreads = gridDim.x * PT;
  const int gtid = blockIdx.x * PT + threadIdx.x;
  // A: nbr, s_i and s_j
  for (int e = gtid; e < E; e += gthreads)
    nbr[e] = (e / (nx * K)) * nx + p.idx[e % (nx * K)];
  int base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const LayerW<T>& w = p.w[l];
    base = product<RND>(base, R, 2 * H, H + D + 1 + V,
                        SidesIn<T>{p.h, p.u, p.px, p.v, H, D, V},
                        SidesW<T>{w.w_hi, w.w_hj, w.w_du, w.w_dx, w.w_v, H,
                                  D},
                        StoreSides{L[l].si, L[l].sj, w.b1, H}, smem);
  }
  phase_end(grid, 1);
  // A2: m0, the edges' pre-activations
#pragma unroll
  for (int l = 0; l < NL; ++l)
    for (int q = gtid; q < EH; q += gthreads) {
      const int e = q / H, c = q % H;
      const float si = L[l].si[(e / K) * H + c], sj = L[l].sj[nbr[e] * H + c];
      L[l].m0[q] = RND ? bf16r(si) + bf16r(sj) : si + sj;
    }
  phase_end(grid, 2);
  // B: z2
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l)
    base = product<RND, EDGE_TC>(base, E, H, H, Sw{L[l].m0, H},
                                 Mat{p.w[l].w2, H},
                                 StoreBias{L[l].z2, p.w[l].b2, H}, smem);
  phase_end(grid, 3);
  // B2: agg
#pragma unroll
  for (int l = 0; l < NL; ++l)
    for (int q = gtid; q < RH; q += gthreads) {
      const int r = q / H, c = q % H;
      const float* m = p.mask + (r % nx) * K;
      float s = 0.0f, deg = 0.0f;
      if constexpr (RND) {  // a sum of products with bf16(mask / deg)
        for (int k = 0; k < K; ++k) deg += m[k];
        deg = fmaxf(deg, 1.0f);
        for (int k = 0; k < K; ++k)
          s += bf16r(m[k] / deg) * bf16r(swish(L[l].z2[(r * K + k) * H + c]));
        L[l].agg[q] = s;
      } else {
        for (int k = 0; k < K; ++k) {
          s += swish(L[l].z2[(r * K + k) * H + c]) * m[k];
          deg += m[k];
        }
        L[l].agg[q] = s / fmaxf(deg, 1.0f);
      }
    }
  phase_end(grid, 4);
  // C: z3
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l)
    base = product<RND>(base, R, H, 2 * H + V,
                        UpdIn<T>{p.h, L[l].agg, p.v, H, V}, Mat{p.w[l].w3, H},
                        StoreBias{L[l].z3, p.w[l].b3, H}, smem);
  phase_end(grid, 5);
  // D: z4
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l)
    base = product<RND>(base, R, H, H, Sw{L[l].z3, H}, Mat{p.w[l].w4, H},
                        StoreBias{L[l].z4, p.w[l].b4, H}, smem);
  phase_end(grid, 6);
}

// The whole forward; NL = 2 is the gated pair (both layers GNN_LayerLin),
// whose stash (gn, ln) STASH writes; MM the precision mode.
template <int NL, bool FA, bool RES, bool STASH, int MM>
__device__ __forceinline__ void forward(const Params<MM>& p, float* smem) {
  static_assert(NL == 1 || (!FA && !RES), "the pair's layers are LayerLin");
  static_assert(NL == 2 || !STASH, "the stash is the pair's");
  cg::grid_group grid = cg::this_grid();
  if (PHASE_TIMES) phase_end(grid, 0);
  const int R = p.B * p.nx;
  const long per = fwd_layer_floats(R, p.H, p.K);
  Lay L[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l)
    L[l] = layer_bufs(p.scratch, l, per, R, p.H, p.K);
  int* nbr = reinterpret_cast<int*>(p.scratch + NL * per);
  forward_phases<NL>(p, L, nbr, smem, grid);
  // E: InstanceNorm (and the pair's combine) into out
  norm_fwd<NL, FA, RES, STASH>(p, L, smem);
  if (PHASE_TIMES) phase_end(grid, 7);
}

// The whole backward; NL = 2 is the gated pair (both layers GNN_LayerLin);
// MM the precision mode.
template <int NL, bool FA, bool RES, int MM>
__device__ __forceinline__ void backward(const Params<MM>& p, float* smem) {
  static_assert(NL == 1 || (!FA && !RES), "the pair's layers are LayerLin");
  using T = In<MM>;
  constexpr bool RND = MM != 0;
  cg::grid_group grid = cg::this_grid();
  if (PHASE_TIMES) phase_end(grid, 0);
  const int nx = p.nx, H = p.H, D = p.D, V = p.V, K = p.K;
  const int R = p.B * nx, E = R * K, RH = R * H;
  const GradOff go(H, D, V);
  const int stride = NL * go.total;      // floats of a node chunk's partials
  const int estride = NL * (H * H + H);  // of an edge chunk's
  Lay L[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l)
    L[l] = layer_bufs(p.scratch, l, layer_floats(R, H, K), R, H, K);
  float* npart = p.scratch + NL * layer_floats(R, H, K);
  float* epart = npart + (long)cdiv(R, CHUNK) * stride;
  int* nbr = reinterpret_cast<int*>(epart + (long)cdiv(R, CHUNK_E) * estride);
  const int gthreads = gridDim.x * PT;
  const int gtid = blockIdx.x * PT + threadIdx.x;
  // a node chunk's partial slice of layer l's gradient at offset off
  auto part = [&](int l, int off) {
    return [=](int c) {
      return npart + (long)c * stride + l * go.total + off;
    };
  };

  // A (the backward's part): the transposed weights
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const LayerW<T>& w = p.w[l];
    for (int q = gtid; q < H * H; q += gthreads) {
      const int k = q / H, n = q % H;  // element (k, n) of the transposes
      L[l].t4[q] = f32(w.w4[n * H + k]);
      L[l].t2[q] = f32(w.w2[n * H + k]);
      L[l].t3[k * 2 * H + n] = f32(w.w3[n * H + k]);
      L[l].t3[k * 2 * H + H + n] = f32(w.w3[(H + n) * H + k]);
      L[l].thj[q] = f32(w.w_hi[n * H + k]);
      L[l].thj[H * H + q] = f32(w.w_hj[n * H + k]);
    }
  }
  // A-D: the layers' forward
  forward_phases<NL>(p, L, nbr, smem, grid);
  // E: InstanceNorm (and the pair's combine) forward and backward
  norm_bwd<NL, FA, RES>(p, L, smem);
  phase_end(grid, 7);
  int base;
  // F: dz3, dw4 and db4
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    base = product<RND>(base, R, H, H, Mat{L[l].dz4, H}, Mat{L[l].t4, H},
                        StoreDeriv{L[l].dz3, L[l].z3, H}, smem);
    auto out = part(l, go.w4);
    auto col = part(l, go.b4);
    base = grad<RND>(base, H, H, R, CHUNK, Tr<Sw>{{L[l].z3, H}},
                Mat{L[l].dz4, H}, [=](int c) { return Store{out(c), H}; },
                [=](int c) { return Col{col(c), H}; }, smem);
  }
  phase_end(grid, 8);
  // G: dh3 and dagg into dz2; dw3 and db3
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    base = product<RND>(
        base, R, 2 * H, H, Mat{L[l].dz3, H}, Mat{L[l].t3, 2 * H},
        StoreDh3Dz2<RND>{L[l].dh3, L[l].dz2, L[l].z2, p.mask, H, K, nx},
        smem);
    auto out = part(l, go.w3);
    auto col = part(l, go.b3);
    base = grad<RND>(base, 2 * H + V, H, R, CHUNK,
                Tr<UpdIn<T>>{{p.h, L[l].agg, p.v, H, V}}, Mat{L[l].dz3, H},
                [=](int c) { return Store{out(c), H}; },
                [=](int c) { return Col{col(c), H}; }, smem);
  }
  phase_end(grid, 9);
  // H: dm0 over z2; dw2 and db2 (edge chunks)
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    base = product<RND, EDGE_TC>(base, E, H, H, Mat{L[l].dz2, H},
                                 Mat{L[l].t2, H},
                                 StoreDeriv{L[l].z2, L[l].m0, H}, smem);
    float* ep = epart + l * (H * H + H);
    base = grad<RND, EDGE_TC>(
        base, H, H, E, CHUNK_E * K, Tr<Sw>{{L[l].m0, H}}, Mat{L[l].dz2, H},
        [=](int c) { return Store{ep + (long)c * estride, H}; },
        [=](int c) { return Col{ep + (long)c * estride + H * H, H}; }, smem);
  }
  phase_end(grid, 10);
  // I: ds_i and ds_j from dm0
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const float* dm0 = L[l].z2;
    for (int q = gtid; q < RH; q += gthreads) {
      const int r = q / H, c = q % H, i = r % nx;
      float a = 0.0f, b = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float x = dm0[(r * K + k) * H + c];
        a += RND ? bf16r(x) : x;
      }
      // this graph's edges
      const float* g0 = dm0 + (long)(r - i) * K * H + c;
      for (int j = p.rev_ptr[i]; j < p.rev_ptr[i + 1]; ++j) {
        const int e = p.rev_e[j];
        b += (RND ? bf16r(g0[e * H]) : g0[e * H]) * p.mask[e];
      }
      L[l].dsi[q] = a;
      L[l].dsj[q] = b;
    }
  }
  phase_end(grid, 11);
  // J: dh (the pair: each layer's term, in its dh3); [dw_hi dw_hj] and
  // db1; [dw_du; dw_dx]; dw_v
  base = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const Cat2 ds{L[l].dsi, L[l].dsj, H};
    if constexpr (NL == 1)
      base = product<RND>(base, R, H, 2 * H, ds, Mat{L[l].thj, H},
                          StoreAdd2{p.dh, L[l].dh3, H}, smem);
    else
      base = product<RND>(base, R, H, 2 * H, ds, Mat{L[l].thj, H},
                          StoreAdd{L[l].dh3, H}, smem);
    auto hi = part(l, go.hi);
    auto hj = part(l, go.hj);
    auto b1 = part(l, go.b1);
    base = grad<RND>(base, H, 2 * H, R, CHUNK, MatT{p.h, H}, ds,
                [=](int c) { return StoreSplit{hi(c), hj(c), H}; },
                [=](int c) { return Col{b1(c), H}; }, smem);
    auto du = part(l, go.du);  // dw_du and dw_dx are adjacent
    // dmix = ds_i - ds_j, rounded (in the bf16 modes) as the W operand
    base = grad<RND>(base, D + 1, H, R, CHUNK, Tr<MixIn<T>>{{p.u, p.px, D}},
                Diff{L[l].dsi, L[l].dsj, H},
                [=](int c) { return Store{du(c), H}; },
                [](int) { return NoCol{}; }, smem);
    auto dv = part(l, go.v);
    base = grad<RND>(base, V, H, R, CHUNK, MatT{p.v, V}, Mat{L[l].dsi, H},
                [=](int c) { return Store{dv(c), H}; },
                [](int) { return NoCol{}; }, smem);
  }
  phase_end(grid, 12);
  // K: the weight gradients, chunk partials summed in chunk order; the
  // pair's dh
  const int nch = cdiv(R, CHUNK), nche = cdiv(R, CHUNK_E);
  for (int i = gtid; i < stride; i += gthreads) {
    const int l = i / go.total, off = i - l * go.total;
    float s = 0.0f;
    if (off >= go.w2 && off < go.w3) {
      const float* e = epart + l * (H * H + H) + off - go.w2;
      for (int c = 0; c < nche; ++c) s += e[(long)c * estride];
    } else {
      for (int c = 0; c < nch; ++c) s += npart[(long)c * stride + i];
    }
    p.dw[i] = s;
  }
  if constexpr (NL == 2)
    for (int q = gtid; q < RH; q += gthreads)
      p.dh[q] = p.dh[q] + L[0].dh3[q] + L[1].dh3[q];
  if (PHASE_TIMES) phase_end(grid, 13);
}

// The cooperative grid of `kernel`: as many blocks as fit on every SM at
// once, asked of the runtime once a kernel and device. Returns a CUDA error
// when the card cannot launch it cooperatively or not one block fits; the
// entry points pass that on and launch nothing.
inline int cooperative_grid(const void* kernel, int* blocks) {
  struct Known {
    const void* kernel;
    int dev, blocks;
  };
  static Known known[16];
  static int n_known = 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].dev == dev) {
      *blocks = known[i].blocks;
      return 0;
    }
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PT,
                                                        0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (n_known < 16) known[n_known++] = Known{kernel, dev, *blocks};
  return 0;
}

template <int MM>
inline int launch(const void* kernel, Params<MM> p, cudaStream_t st) {
  int blocks = 0;
  const int err = cooperative_grid(kernel, &blocks);
  if (err) return err;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(kernel, blocks, PT, args, 0, st);
}

}  // namespace phases
}  // namespace mp
