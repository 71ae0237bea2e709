// Operand loaders and stores of one GNN_LayerLin for block_gemm, shared by
// the pair's forward (mp_pair_fwd.cu) and backward (mp_pair_bwd.cu).
// Layouts per graph: h, s_i, s_j, agg [nx, H]; u [nx, D]; px [nx];
// v [nx, V]; edge rows e = i*K + k with neighbour idx[e] and mask[e].
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

}  // namespace mp
