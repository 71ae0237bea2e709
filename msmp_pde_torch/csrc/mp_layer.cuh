// One message-passing layer: its weights and the operand loaders and stores
// that the phases of mp_phases.cuh fuse into their products. All four
// message-passing kernels (mp_pair_fwd.cu, mp_layer_fwd.cu, mp_pair_bwd.cu,
// mp_layer_bwd.cu) run those phases; each source builds into a library of
// its own. Layouts: node rows r of h, s_i, s_j, agg [R, H]; u [R, D];
// px [R]; v [R, V].
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

struct StoreSides {  // s_i = acc + b1 (columns [0, H)), s_j = acc
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

struct StoreBias {  // out = acc + b
  float* out;
  const float* b;
  int H;
  __device__ void operator()(int r, int n, float acc) const {
    out[r * H + n] = acc + b[n];
  }
};

}  // namespace mp
