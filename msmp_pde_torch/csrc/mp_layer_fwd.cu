// One message-passing layer, forward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_fwd_kernel, driven there by
// make_fused_layer._run_fwd and fused_mp_layer.
//
// For one graph with inputs h [nx,H], u [nx,D], px [nx], v [nx,V] it
// computes the layer of mp_layer.cuh (the TPU kernel's _forward_math) and
// its InstanceNorm. FINAL_ACT and RESIDUAL are template parameters: the
// ungated models' GNN_Layer takes both (o = h + swish(z4)), GNN_LayerLin
// neither; these two are built. The TPU kernel gathers and aggregates with one-hot matrices
// (E, G, A) on its matrix unit; here the gather reads idx directly and the
// mean walks the K neighbour slots.
//
// What bounds it on an H100: operations. At B = 16, nx = 100, K = 6,
// H = 128 one layer is ~0.58 GFLOP of float32 (the per-edge w2 product is
// half of it) against ~1.4 MB of inputs and weights and 0.8 MB of output.
//
// Design (simple and right first), as the pair's (mp_pair_fwd.cu):
// * InstanceNorm reduces over a graph's nodes, so one block owns one
//   graph; a batch of B keeps B of the 132 SMs busy.
// * The node and edge intermediates live in a scratch buffer the wrapper
//   allocates (mp_layer_fwd_scratch_floats per graph, 0.6 MB at E1), which
//   stays in L2; the pre-norm output is written straight into the output
//   and normalized there in place.
// * Every product is a block_gemm with plain FMAs.
#include "mp_layer.cuh"

namespace {

using namespace mp;

// si, sj, agg, z3, z4 [nx, H], z2 [nx*K, H], rs [H]
__host__ __device__ inline long scratch_floats(int nx, int H, int K) {
  return 5L * nx * H + (long)nx * K * H + H;
}

template <bool FINAL_ACT, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
mp_layer_fwd_kernel(const float* __restrict__ h, const float* __restrict__ u,
                    const float* __restrict__ px, const float* __restrict__ v,
                    const int* __restrict__ idx,
                    const float* __restrict__ mask, LayerW w,
                    float* __restrict__ out, float* scratch, int nx, int H,
                    int D, int V, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int b = blockIdx.x;
  const size_t nh = (size_t)nx * H;
  float* base = scratch + (size_t)b * scratch_floats(nx, H, K);
  Bufs s{};
  s.si = base;
  s.sj = base + nh;
  s.agg = base + 2 * nh;
  s.z3 = base + 3 * nh;
  s.z4 = base + 4 * nh;
  s.z2 = base + 5 * nh;
  s.rs = s.z2 + (size_t)nx * K * H;
  s.xo = out + b * nh;
  const Graph G{h + b * nh, u + (size_t)b * nx * D, px + (size_t)b * nx,
                v + (size_t)b * nx * V, idx, mask, nx, H, D, V, K};
  layer_fwd<FINAL_ACT, RESIDUAL>(w, G, s, As, Ws);
}

template <bool FINAL_ACT, bool RESIDUAL>
int launch(const float* h, const float* u, const float* px, const float* v,
           const int* idx, const float* mask, LayerW w, float* out,
           float* scratch, int B, int nx, int H, int D, int V, int K,
           cudaStream_t st) {
  mp_layer_fwd_kernel<FINAL_ACT, RESIDUAL><<<B, THREADS, 0, st>>>(
      h, u, px, v, idx, mask, w, out, scratch, nx, H, D, V, K);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const float*, const float*, const float*, const float*,
                     const int*, const float*, LayerW, float*, float*, int,
                     int, int, int, int, int, cudaStream_t);

}  // namespace

extern "C" long mp_layer_fwd_scratch_floats(int nx, int H, int K) {
  return scratch_floats(nx, H, K);
}

// out: [B, nx, H]; scratch: B * mp_layer_fwd_scratch_floats floats.
extern "C" int mp_layer_fwd(const float* h, const float* u, const float* px,
                            const float* v, const int* idx, const float* mask,
                            const void* const* w, float* out, float* scratch,
                            int B, int nx, int H, int D, int V, int K,
                            int final_act, int residual, void* stream) {
  // GNN_Layer (both switches) or GNN_LayerLin (neither): the two layers
  // the models build; the wrapper refuses the mixed cases.
  if ((final_act != 0) != (residual != 0)) return (int)cudaErrorInvalidValue;
  const Launch run = final_act ? launch<true, true> : launch<false, false>;
  return run(
      h, u, px, v, idx, mask, unpack(w), out, scratch, B, nx, H, D, V,
      K, (cudaStream_t)stream);
}
