// Fused gated message-passing pair, backward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_pair_bwd_kernel, driven there
// by _pair_bwd_call from make_fused_pair's custom VJP.
//
// For one graph with output cotangent g [nx,H], in the TPU kernel's
// recompute order (only one layer's intermediates live at a time):
//   pass 1: gate layer forward -> gn, tau = sigmoid(gn);
//   pass 2: main layer forward -> ln; combine backward
//           dln = g tau swish'(ln),  dgn = g (swish(ln) - h) tau (1 - tau),
//           dh = g (1 - tau); InstanceNorm backward and the layer backward
//           (dh += ..., 12 weight gradients);
//   pass 3: gate layer forward again, its InstanceNorm and layer backward.
// The layer backward is mp_pallas.py::_layer_bwd_math (layer_bwd in
// mp_layer.cuh):
//   dxo = rs (cot - mean(cot) - xh mean(cot xh))         (per feature)
//   dw4 = a3^T dxo, dz3 = dxo w4^T * swish'(z3), dw3 = [h,agg,v]^T dz3,
//   dh += dz3 w3[:H]^T, dagg = dz3 w3[H:2H]^T,
//   dz2[i,k] = mask[i,k]/deg[i] dagg[i] * swish'(z2),  dw2 = m1^T dz2,
//   dm0 = dz2 w2^T * swish'(m0), ds_i[i] = sum_k dm0[i,k],
//   ds_j[n] = sum over valid edges (i,k) with idx[i,k] = n of dm0[i,k],
//   dh += ds_i w_hi^T + ds_j w_hj^T, dw_hi = h^T ds_i, dw_hj = h^T ds_j,
//   [dw_du; dw_dx] = [u, px]^T (ds_i - ds_j), dw_v = v^T ds_i,
//   and the bias gradients are column sums.
//
// What bounds it on an H100: operations. Three layer forwards and two
// layer backwards (each about twice a forward) are ~3.5x the pair
// forward's ~1.16 GFLOP at B = 16, against ~2.1 MB of inputs, cotangent
// and weights and ~1.6 MB of outputs.
//
// Design (simple and right first):
// * One block owns one graph (InstanceNorm and the scatter need all of
//   it), as in mp_pair_fwd.cu; the same occupancy limit applies.
// * The TPU grid accumulates the 24 weight gradients across its
//   sequential steps in VMEM. Here blocks run at once, so each block
//   writes its graph's gradients to its own slice of a partial buffer and
//   a second launch sums the slices over the batch in a fixed order. No
//   float atomics: the gradients are bitwise repeatable.
// * ds_j, the transpose of the neighbour gather, is a scatter. Each block
//   first builds the inverse neighbour list of its graph in increasing
//   edge order (a counting pass per target node, nx threads), so the
//   scatter becomes a gather-sum in a fixed order. Invalid slots (mask 0,
//   pointing at node 0) are left out.
// * Every product is a block_gemm (block_gemm.cuh); the weight gradients
//   (X^T dY, reduction over nodes or edges) load their transposed operand
//   with consecutive threads on consecutive features. Activations and
//   their derivatives are recomputed in the loaders and stores from the
//   pre-activations z2, z3 and from s_i, s_j, so the scratch holds only
//   z2 (then dz2, in place) and dm0 per edge.
// * Scratch per graph, in the wrapper's buffer: 13 [nx,H] node buffers,
//   2 [nx*K,H] edge buffers (1.3 MB per graph at E1, in L2), H floats of
//   rsqrt factors and the inverse list.
#include "mp_layer.cuh"

namespace {

using namespace mp;

// The pair's scratch per graph: gn, cot, dgn and the layer's 10 node
// buffers, the 2 edge buffers, rs and the inverse neighbour list.
__host__ __device__ inline long scratch_floats(int nx, int H, int D, int V,
                                               int K) {
  return 13L * nx * H + 2L * nx * K * H + H + (nx + 1) + nx * K;
}

__global__ void __launch_bounds__(THREADS)
mp_pair_bwd_kernel(const float* __restrict__ h, const float* __restrict__ u,
                   const float* __restrict__ px, const float* __restrict__ v,
                   const int* __restrict__ idx, const float* __restrict__ mask,
                   LayerW wg, LayerW wl, const float* __restrict__ g,
                   float* __restrict__ dh, float* __restrict__ partial,
                   float* scratch, int nx, int H, int D, int V, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int b = blockIdx.x;
  const size_t nh = (size_t)nx * H;
  float* base = scratch + (size_t)b * scratch_floats(nx, H, D, V, K);
  float* node[13];
  for (int i = 0; i < 13; ++i) node[i] = base + i * nh;
  float* gn = node[0];
  float* cot = node[1];
  float* dgn = node[2];
  Bufs s{node[3], node[4], node[5], node[6], node[7], node[8], node[9],
         node[10], node[11], node[12], base + 13 * nh,
         base + 13 * nh + (size_t)nx * K * H,
         base + 13 * nh + 2 * (size_t)nx * K * H};
  int* rev_ptr = reinterpret_cast<int*>(s.rs + H);
  int* rev_e = rev_ptr + nx + 1;
  const Graph G{h + b * nh, u + (size_t)b * nx * D, px + (size_t)b * nx,
                v + (size_t)b * nx * V, idx, mask, rev_ptr, rev_e,
                nx, H, D, V, K};
  const float* gb = g + b * nh;
  float* dhb = dh + b * nh;
  const int per_layer = GradOff(H, D, V).total;
  float* dwg = partial + (size_t)b * 2 * per_layer;
  float* dwl = dwg + per_layer;

  build_inverse(G, rev_ptr, rev_e);
  // pass 1: gate forward, keep gn
  layer_fwd<false, false>(wg, G, s, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) gn[q] = s.xo[q];
  __syncthreads();
  // pass 2: main forward, combine backward, main backward
  layer_fwd<false, false>(wl, G, s, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const float tau = sigm(gn[q]), ln = s.xo[q], gq = gb[q];
    cot[q] = gq * tau * dswish(ln);
    dgn[q] = gq * (swish(ln) - G.h[q]) * tau * (1.0f - tau);
    dhb[q] = gq * (1.0f - tau);
  }
  __syncthreads();
  layer_bwd<false, false>(wl, cot, G, s, dhb, dwl, As, Ws);
  // pass 3: gate forward again, gate backward
  layer_fwd<false, false>(wg, G, s, As, Ws);
  layer_bwd<false, false>(wg, dgn, G, s, dhb, dwg, As, Ws);
}

}  // namespace

extern "C" long mp_pair_bwd_scratch_floats(int nx, int H, int D, int V,
                                           int K) {
  return scratch_floats(nx, H, D, V, K);
}

// dw: [gate 12 | main 12] gradients, flat in parameter order and shapes;
// partial: B times that; scratch: B * mp_pair_bwd_scratch_floats floats.
extern "C" int mp_pair_bwd(const float* h, const float* u, const float* px,
                           const float* v, const int* idx, const float* mask,
                           const void* const* wg, const void* const* wl,
                           const float* g, float* dh, float* dw,
                           float* partial, float* scratch, int B, int nx,
                           int H, int D, int V, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  mp_pair_bwd_kernel<<<B, THREADS, 0, st>>>(
      h, u, px, v, idx, mask, unpack(wg), unpack(wl), g, dh, partial,
      scratch, nx, H, D, V, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * GradOff(H, D, V).total;
  reduce_graphs<<<reduce_blocks(n), REDUCE_THREADS, 0, st>>>(partial, dw, B,
                                                          n);
  return (int)cudaGetLastError();
}
