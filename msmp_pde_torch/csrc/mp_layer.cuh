// One message-passing layer for block_gemm: operand loaders and stores,
// the layer's forward and backward for one graph, and the fixed-order sum
// of per-graph weight gradients. Shared by the pair's forward
// (mp_pair_fwd.cu) and backward (mp_pair_bwd.cu) and by the single layer's
// forward (mp_layer_fwd.cu) and backward (mp_layer_bwd.cu); each source
// builds into a library of its own.
// Layouts per graph: h, s_i, s_j, agg [nx, H]; u [nx, D]; px [nx];
// v [nx, V]; edge rows e = i*K + k with neighbour idx[e] and mask[e].
//
// The layer (mp_pallas.py::_forward_math, then _instnorm):
//   mix = u w_du + px w_dx,  s_i = h w_hi + mix + v w_v + b1,  s_j = h w_hj - mix
//   z2[i,k] = swish(s_i[i] + s_j[idx[i,k]]) w2 + b2
//   agg[i]  = sum_k mask[i,k] swish(z2[i,k]) / max(sum_k mask[i,k], 1)
//   z3 = [h, agg, v] w3 + b3,  z4 = swish(z3) w4 + b4
//   o  = [h +] [swish](z4), then InstanceNorm over the nodes.
// FINAL_ACT and RESIDUAL are the bracketed terms: both for GNN_Layer,
// neither for GNN_LayerLin (the gated pair's two layers). They are template
// parameters, so the pair's <false, false> code has no branch on them.
#pragma once
#include "block_gemm.cuh"

namespace mp {

struct LayerW {  // the 12 weights in the flax layout, biases [H]
  const float *w_hi, *w_hj, *w_du, *w_dx, *w_v, *b1, *w2, *b2, *w3, *b3,
      *w4, *b4;
};

inline LayerW unpack(const void* const* p) {
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = static_cast<const float*>(p[i]);
  return LayerW{f[0], f[1], f[2], f[3], f[4], f[5],
                f[6], f[7], f[8], f[9], f[10], f[11]};
}

struct HW {  // [w_hi | w_hj]
  const float *w_hi, *w_hj;
  int H;
  __device__ float operator()(int k, int n) const {
    return n < H ? w_hi[k * H + n] : w_hj[k * H + n - H];
  }
};

struct StoreSides {  // s_i = h w_hi + b1, s_j = h w_hj
  float *si, *sj;
  const float* b1;
  int H;
  __device__ void operator()(int r, int n, float acc) const {
    if (n < H) si[r * H + n] = acc + b1[n];
    else sj[r * H + n - H] = acc;
  }
};

struct MixIn {  // row r of [u | px]
  const float *u, *px;
  int D;
  __device__ float operator()(int r, int c) const {
    return c < D ? u[r * D + c] : px[r];
  }
};

struct MixW {  // [w_du ; w_dx]
  const float *w_du, *w_dx;
  int H, D;
  __device__ float operator()(int k, int n) const {
    return k < D ? w_du[k * H + n] : w_dx[n];
  }
};

struct StoreMix {  // mix = u w_du + px w_dx: s_i += mix + v w_v, s_j -= mix
  float *si, *sj;
  const float *v, *w_v;
  int H, V;
  __device__ void operator()(int r, int n, float acc) const {
    float vw = 0.0f;
    for (int k = 0; k < V; ++k) vw = fmaf(v[r * V + k], w_v[k * H + n], vw);
    si[r * H + n] += acc + vw;
    sj[r * H + n] -= acc;
  }
};

struct EdgeIn {  // edge e = (i, k): swish(s_i[i] + s_j[idx[i, k]])
  const float *si, *sj;
  const int* idx;
  int H, K;
  __device__ float operator()(int e, int c) const {
    return swish(si[(e / K) * H + c] + sj[idx[e] * H + c]);
  }
};

struct UpdIn {  // row r of [h | agg | v]
  const float *h, *agg, *v;
  int H, V;
  __device__ float operator()(int r, int c) const {
    if (c < H) return h[r * H + c];
    c -= H;
    if (c < H) return agg[r * H + c];
    return v[r * V + c - H];
  }
};

struct StoreBias {
  float* out;
  const float* b;
  int H;
  bool act;
  __device__ void operator()(int r, int n, float acc) const {
    const float x = acc + b[n];
    out[r * H + n] = act ? swish(x) : x;
  }
};

template <class F>
struct Tr {  // the transpose of a loader: (a, b) -> f(b, a)
  F f;
  __device__ float operator()(int a, int b) const { return f(b, a); }
};

struct SwishIn {  // swish of row-major pre-activations
  const float* z;
  int ld;
  __device__ float operator()(int r, int c) const { return swish(z[r * ld + c]); }
};

struct Store {  // out[m, n] = acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const { out[m * ld + n] = acc; }
};

struct StoreAdd {  // out[m, n] += acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const { out[m * ld + n] += acc; }
};

struct StoreDeriv {  // out[m, n] = acc * swish'(z[m, n])
  float* out;
  const float* z;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] = acc * dswish(z[m * ld + n]);
  }
};

struct StoreDm0 {  // dm0[e, n] = acc * swish'(s_i[i] + s_j[idx[e]])
  float* dm0;
  const float *si, *sj;
  const int* idx;
  int H, K;
  __device__ void operator()(int e, int n, float acc) const {
    dm0[e * H + n] = acc * dswish(si[(e / K) * H + n] + sj[idx[e] * H + n]);
  }
};

struct StoreDhDagg {  // columns [0, H) add into dh, [H, 2H) set dagg
  float *dh, *dagg;
  int H;
  __device__ void operator()(int r, int n, float acc) const {
    if (n < H) dh[r * H + n] += acc;
    else dagg[r * H + n - H] = acc;
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

struct Cat2 {  // row r of [a | b], each [., H]
  const float *a, *b;
  int H;
  __device__ float operator()(int r, int c) const {
    return c < H ? a[r * H + c] : b[r * H + c - H];
  }
};

struct HWT {  // [w_hi^T ; w_hj^T]
  const float *w_hi, *w_hj;
  int H;
  __device__ float operator()(int k, int n) const {
    return k < H ? w_hi[n * H + k] : w_hj[n * H + k - H];
  }
};

struct Diff {  // ds_i - ds_j
  const float *a, *b;
  int H;
  __device__ float operator()(int k, int n) const {
    return a[k * H + n] - b[k * H + n];
  }
};

template <bool FINAL_ACT, bool RESIDUAL>
struct StoreOut {  // z4 = acc + b4 (kept with FINAL_ACT); o = [h +] [swish](z4)
  float *o, *z4;
  const float *h, *b4;
  int H;
  __device__ void operator()(int r, int n, float acc) const {
    const float z = acc + b4[n];
    if (FINAL_ACT) z4[r * H + n] = z;
    const float a = FINAL_ACT ? swish(z) : z;
    o[r * H + n] = RESIDUAL ? h[r * H + n] + a : a;
  }
};

struct Graph {  // one graph's inputs
  const float *h, *u, *px, *v;
  const int* idx;
  const float* mask;
  const int *rev_ptr, *rev_e;  // inverse neighbour list (backward only)
  int nx, H, D, V, K;
};

struct Bufs {  // one graph's scratch; z4 only with FINAL_ACT
  float *si, *sj, *agg, *z3, *xo, *dxo, *dz3, *dagg, *dsi, *dsj, *z2, *dm0,
      *rs, *z4;
};

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

// Column sums of a [rows, H] buffer, each in row order.
__device__ inline void colsum(const float* x, int rows, int H, float* out) {
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += x[r * H + c];
    out[c] = s;
  }
}

// One layer's forward; keeps s_i, s_j, z2, agg, z3 (and z4 with FINAL_ACT)
// and writes the normalized output into xo and its rsqrt factors into rs.
// At <false, false> the arithmetic is mp_pair_fwd.cu's, operation for
// operation.
template <bool FINAL_ACT, bool RESIDUAL>
__device__ void layer_fwd(const LayerW& w, const Graph& G, const Bufs& s,
                          float (*As)[BM + 4], float (*Ws)[BN]) {
  const int nx = G.nx, H = G.H, K = G.K;
  block_gemm(nx, 2 * H, H, Mat{G.h, H}, HW{w.w_hi, w.w_hj, H},
             StoreSides{s.si, s.sj, w.b1, H}, As, Ws);
  block_gemm(nx, H, G.D + 1, MixIn{G.u, G.px, G.D},
             MixW{w.w_du, w.w_dx, H, G.D},
             StoreMix{s.si, s.sj, G.v, w.w_v, H, G.V}, As, Ws);
  block_gemm(nx * K, H, H, EdgeIn{s.si, s.sj, G.idx, H, K}, Mat{w.w2, H},
             StoreBias{s.z2, w.b2, H, false}, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const int i = q / H, c = q % H;
    float sum = 0.0f, deg = 0.0f;
    for (int k = 0; k < K; ++k) {
      sum += swish(s.z2[(i * K + k) * H + c]) * G.mask[i * K + k];
      deg += G.mask[i * K + k];
    }
    s.agg[q] = sum / fmaxf(deg, 1.0f);
  }
  __syncthreads();
  block_gemm(nx, H, 2 * H + G.V, UpdIn{G.h, s.agg, G.v, H, G.V},
             Mat{w.w3, H}, StoreBias{s.z3, w.b3, H, false}, As, Ws);
  block_gemm(nx, H, H, SwishIn{s.z3, H}, Mat{w.w4, H},
             StoreOut<FINAL_ACT, RESIDUAL>{s.xo, s.z4, G.h, w.b4, H}, As,
             Ws);
  float* o = s.xo;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float mean = 0.0f;
    for (int r = 0; r < nx; ++r) mean += o[r * H + c];
    mean /= nx;
    float var = 0.0f;
    for (int r = 0; r < nx; ++r) {
      const float d = o[r * H + c] - mean;
      var += d * d;
    }
    const float rs = 1.0f / sqrtf(var / nx + 1e-5f);
    for (int r = 0; r < nx; ++r) o[r * H + c] = (o[r * H + c] - mean) * rs;
    s.rs[c] = rs;
  }
  __syncthreads();
}

// The layer's backward from the cotangent of its normalized output, right
// after layer_fwd of the same layer: adds into dh (with RESIDUAL, the
// pre-norm cotangent first) and writes the 12 weight gradients of this
// graph into dw (mp_pallas.py::_layer_bwd_math).
template <bool FINAL_ACT, bool RESIDUAL>
__device__ void layer_bwd(const LayerW& w, const float* cot, const Graph& G,
                          const Bufs& s, float* dh, float* dw,
                          float (*As)[BM + 4], float (*Ws)[BN]) {
  const int nx = G.nx, H = G.H, K = G.K, D = G.D, V = G.V;
  const GradOff o(H, D, V);
  // InstanceNorm backward to dxo, then dz4 = dxo [* swish'(z4)] into s.dxo
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float mg = 0.0f, mgx = 0.0f;
    for (int r = 0; r < nx; ++r) {
      mg += cot[r * H + c];
      mgx += cot[r * H + c] * s.xo[r * H + c];
    }
    mg /= nx;
    mgx /= nx;
    float db4 = 0.0f;
    for (int r = 0; r < nx; ++r) {
      const float d = s.rs[c] * (cot[r * H + c] - mg - s.xo[r * H + c] * mgx);
      if (RESIDUAL) dh[r * H + c] += d;
      const float dz = FINAL_ACT ? d * dswish(s.z4[r * H + c]) : d;
      s.dxo[r * H + c] = dz;
      db4 += dz;
    }
    dw[o.b4 + c] = db4;
  }
  __syncthreads();
  block_gemm<true>(H, H, nx, Tr<SwishIn>{{s.z3, H}}, Mat{s.dxo, H},
                   Store{dw + o.w4, H}, As, Ws);
  block_gemm(nx, H, H, Mat{s.dxo, H}, MatT{w.w4, H},
             StoreDeriv{s.dz3, s.z3, H}, As, Ws);
  colsum(s.dz3, nx, H, dw + o.b3);
  block_gemm<true>(2 * H + V, H, nx, Tr<UpdIn>{{G.h, s.agg, G.v, H, V}},
                   Mat{s.dz3, H}, Store{dw + o.w3, H}, As, Ws);
  block_gemm(nx, 2 * H, H, Mat{s.dz3, H}, MatT{w.w3, H},
             StoreDhDagg{dh, s.dagg, H}, As, Ws);
  // dz2 over z2, in place
  for (int q = threadIdx.x; q < nx * K * H; q += blockDim.x) {
    const int e = q / H, i = e / K, c = q % H;
    float deg = 0.0f;
    for (int k = 0; k < K; ++k) deg += G.mask[i * K + k];
    s.z2[q] = s.dagg[i * H + c] * (G.mask[e] / fmaxf(deg, 1.0f)) *
              dswish(s.z2[q]);
  }
  __syncthreads();
  colsum(s.z2, nx * K, H, dw + o.b2);
  block_gemm<true>(H, H, nx * K, Tr<EdgeIn>{{s.si, s.sj, G.idx, H, K}},
                   Mat{s.z2, H}, Store{dw + o.w2, H}, As, Ws);
  block_gemm(nx * K, H, H, Mat{s.z2, H}, MatT{w.w2, H},
             StoreDm0{s.dm0, s.si, s.sj, G.idx, H, K}, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const int i = q / H, c = q % H;
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < K; ++k) a += s.dm0[(i * K + k) * H + c];
    for (int p = G.rev_ptr[i]; p < G.rev_ptr[i + 1]; ++p) {
      const int e = G.rev_e[p];
      b += s.dm0[e * H + c] * G.mask[e];
    }
    s.dsi[q] = a;
    s.dsj[q] = b;
  }
  __syncthreads();
  colsum(s.dsi, nx, H, dw + o.b1);
  block_gemm(nx, H, 2 * H, Cat2{s.dsi, s.dsj, H}, HWT{w.w_hi, w.w_hj, H},
             StoreAdd{dh, H}, As, Ws);
  // [dw_hi | dw_hj] and [dw_du ; dw_dx] are adjacent in the slice
  block_gemm<true>(H, 2 * H, nx, MatT{G.h, H}, Cat2{s.dsi, s.dsj, H},
                   StoreSplit{dw + o.hi, dw + o.hj, H}, As, Ws);
  block_gemm<true>(D + 1, H, nx, Tr<MixIn>{{G.u, G.px, D}},
                   Diff{s.dsi, s.dsj, H}, Store{dw + o.du, H}, As, Ws);
  block_gemm<true>(V, H, nx, MatT{G.v, V}, Mat{s.dsi, H},
                   Store{dw + o.v, H}, As, Ws);
}

// The inverse neighbour list of the graph: for each node n, the valid
// edges e with idx[e] = n, in increasing e. The scatter of the neighbour
// gather's transpose becomes a gather-sum in a fixed order.
__device__ inline void build_inverse(const Graph& G, int* rev_ptr,
                                     int* rev_e) {
  const int nE = G.nx * G.K;
  for (int n = threadIdx.x; n < G.nx; n += blockDim.x) {
    int c = 0;
    for (int e = 0; e < nE; ++e) c += (G.mask[e] != 0.0f && G.idx[e] == n);
    rev_ptr[n + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    rev_ptr[0] = 0;
    for (int n = 0; n < G.nx; ++n) rev_ptr[n + 1] += rev_ptr[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < G.nx; n += blockDim.x) {
    int p = rev_ptr[n];
    for (int e = 0; e < nE; ++e)
      if (G.mask[e] != 0.0f && G.idx[e] == n) rev_e[p++] = e;
  }
  __syncthreads();
}

// Launch geometry of reduce_graphs over n gradients.
constexpr int REDUCE_THREADS = 256;
inline int reduce_blocks(int n) { return (n + REDUCE_THREADS - 1) / REDUCE_THREADS; }

// dw[i] = sum over graphs b, in order, of partial[b, i]: the TPU grid's
// sequential accumulation, without float atomics, so bitwise repeatable.
// A template, so that only the sources that launch it compile it.
template <class T>
__global__ void reduce_graphs(const T* __restrict__ partial,
                              T* __restrict__ dw, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = 0;
  for (int b = 0; b < B; ++b) s += partial[(size_t)b * n + i];
  dw[i] = s;
}

}  // namespace mp
