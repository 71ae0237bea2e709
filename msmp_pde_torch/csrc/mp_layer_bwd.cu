// One message-passing layer, backward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_bwd_kernel, driven there by
// _layer_bwd_call from make_fused_layer's custom VJP and from the gated
// pair's fallback backward (make_fused_pair.bwd).
//
// For one graph with output cotangent g [nx,H]: the layer's forward again
// (layer_fwd in mp_layer.cuh), the InstanceNorm backward, and the layer
// backward (layer_bwd, the TPU kernel's _layer_bwd_math): dh and the 12
// weight gradients. With RESIDUAL, dh starts from the pre-norm cotangent;
// with FINAL_ACT, dz4 = dxo swish'(z4) feeds dw4, db4 and the rest.
//
// What bounds it on an H100: operations. One layer forward and one layer
// backward (about twice a forward) are ~1.7 GFLOP at B = 16 against
// ~2.2 MB of inputs, cotangent and weights and ~1.2 MB of outputs.
//
// Design (simple and right first), as the pair's backward
// (mp_pair_bwd.cu):
// * One block owns one graph; it builds the graph's inverse neighbour list
//   so that the scatter of the gather's transpose is a gather-sum in a
//   fixed order.
// * Each block writes its graph's 12 gradients to its own slice of a
//   partial buffer, and a second launch sums the slices over the batch in
//   a fixed order: no float atomics, the gradients are bitwise repeatable.
// * Scratch per graph (mp_layer_bwd_scratch_floats, 1.2 MB at E1) in L2.
#include "mp_layer.cuh"

namespace {

using namespace mp;

// 11 [nx, H] node buffers, z2 and dm0 [nx*K, H], rs [H], then the inverse
// neighbour list (nx + 1 + nx*K ints).
__host__ __device__ inline long scratch_floats(int nx, int H, int K) {
  return 11L * nx * H + 2L * nx * K * H + H + (nx + 1) + nx * K;
}

template <bool FINAL_ACT, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
mp_layer_bwd_kernel(const float* __restrict__ h, const float* __restrict__ u,
                    const float* __restrict__ px, const float* __restrict__ v,
                    const int* __restrict__ idx,
                    const float* __restrict__ mask, LayerW w,
                    const float* __restrict__ g, float* __restrict__ dh,
                    float* __restrict__ partial, float* scratch, int nx,
                    int H, int D, int V, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int b = blockIdx.x;
  const size_t nh = (size_t)nx * H;
  float* base = scratch + (size_t)b * scratch_floats(nx, H, K);
  float* node[11];
  for (int i = 0; i < 11; ++i) node[i] = base + i * nh;
  float* z2 = base + 11 * nh;
  float* dm0 = z2 + (size_t)nx * K * H;
  float* rs = dm0 + (size_t)nx * K * H;
  const Bufs s{node[0], node[1], node[2], node[3], node[4], node[5],
               node[6], node[7], node[8], node[9], z2, dm0, rs, node[10]};
  int* rev_ptr = reinterpret_cast<int*>(rs + H);
  int* rev_e = rev_ptr + nx + 1;
  const Graph G{h + b * nh, u + (size_t)b * nx * D, px + (size_t)b * nx,
                v + (size_t)b * nx * V, idx, mask, rev_ptr, rev_e,
                nx, H, D, V, K};
  float* dhb = dh + b * nh;
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) dhb[q] = 0.0f;
  build_inverse(G, rev_ptr, rev_e);  // ends in __syncthreads()
  layer_fwd<FINAL_ACT, RESIDUAL>(w, G, s, As, Ws);
  layer_bwd<FINAL_ACT, RESIDUAL>(w, g + b * nh, G, s, dhb,
                                 partial + (size_t)b * GradOff(H, D, V).total,
                                 As, Ws);
}

template <bool FINAL_ACT, bool RESIDUAL>
int launch(const float* h, const float* u, const float* px, const float* v,
           const int* idx, const float* mask, LayerW w, const float* g,
           float* dh, float* dw, float* partial, float* scratch, int B,
           int nx, int H, int D, int V, int K, cudaStream_t st) {
  mp_layer_bwd_kernel<FINAL_ACT, RESIDUAL><<<B, THREADS, 0, st>>>(
      h, u, px, v, idx, mask, w, g, dh, partial, scratch, nx, H, D, V, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = GradOff(H, D, V).total;
  reduce_graphs<<<reduce_blocks(n), REDUCE_THREADS, 0, st>>>(partial, dw, B,
                                                          n);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const float*, const float*, const float*, const float*,
                     const int*, const float*, LayerW, const float*, float*,
                     float*, float*, float*, int, int, int, int, int, int,
                     cudaStream_t);

}  // namespace

extern "C" long mp_layer_bwd_scratch_floats(int nx, int H, int K) {
  return scratch_floats(nx, H, K);
}

// dh: [B, nx, H]; dw: the 12 gradients, flat in parameter order and
// shapes; partial: B times that; scratch: B * mp_layer_bwd_scratch_floats
// floats.
extern "C" int mp_layer_bwd(const float* h, const float* u, const float* px,
                            const float* v, const int* idx, const float* mask,
                            const void* const* w, const float* g, float* dh,
                            float* dw, float* partial, float* scratch, int B,
                            int nx, int H, int D, int V, int K, int final_act,
                            int residual, void* stream) {
  // GNN_Layer (both switches) or GNN_LayerLin (neither): the two layers
  // the models build; the wrapper refuses the mixed cases.
  if ((final_act != 0) != (residual != 0)) return (int)cudaErrorInvalidValue;
  const Launch run = final_act ? launch<true, true> : launch<false, false>;
  return run(
      h, u, px, v, idx, mask, unpack(w), g, dh, dw, partial, scratch,
      B, nx, H, D, V, K, (cudaStream_t)stream);
}
