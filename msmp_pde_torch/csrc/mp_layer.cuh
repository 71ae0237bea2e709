// One message-passing layer for block_gemm: operand loaders and stores,
// and the layer's forward for one graph. Shared by the pair's forward
// (mp_pair_fwd.cu) and the single layer's forward (mp_layer_fwd.cu); the
// two backwards (mp_pair_bwd.cu, mp_layer_bwd.cu) run their phases over the
// whole batch (mp_phases.cuh) and take the weights' layout and a few
// loaders from here. Each source builds into a library of its own.
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

struct SwishIn {  // swish of row-major pre-activations
  const float* z;
  int ld;
  __device__ float operator()(int r, int c) const { return swish(z[r * ld + c]); }
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
  int nx, H, D, V, K;
};

struct Bufs {  // one graph's scratch; z4 only with FINAL_ACT
  float *si, *sj, *agg, *z3, *xo, *z2, *rs, *z4;
};

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

}  // namespace mp
