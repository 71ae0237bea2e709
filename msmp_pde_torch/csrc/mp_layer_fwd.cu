// One message-passing layer, forward (float32, or the bf16 modes).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_fwd_kernel, driven there by
// make_fused_layer._run_fwd and fused_mp_layer.
//
// For the batch with inputs h [B,nx,H], u [B,nx,D], px [B,nx], v [B,nx,V]
// it computes the layer of mp_layer.cuh (the TPU kernel's _forward_math)
// and its InstanceNorm over each graph's nodes. FINAL_ACT and RESIDUAL are
// template parameters: the ungated models' GNN_Layer takes both
// (o = h + swish(z4)), GNN_LayerLin neither; these two are built. The TPU
// kernel gathers and aggregates with one-hot matrices (E, G, A) on its
// matrix unit; here the gather reads idx directly and the mean walks the K
// neighbour slots.
//
// What bounds it on an H100: operations. At B = 16, nx = 100, K = 6,
// H = 128 one layer is ~0.58 GFLOP of float32 (the per-edge w2 product is
// half of it) against ~1.4 MB of inputs and weights and 0.8 MB of output.
//
// Design, as the pair's (mp_pair_fwd.cu): the phases A-E of mp_phases.cuh
// with NL = 1, the same A-D that the layer's backward runs, in one
// persistent cooperative kernel over every SM whatever the batch; the
// intermediates in an L2-resident workspace (mp_layer_fwd_scratch_floats,
// 14 MB at batch 16). The precision mode mm (bf16_mma.cuh: 0 float32,
// 1 bfloat16, 2 bfloat16s with h, u, px, v and the weight matrices in bf16)
// is a template parameter: each mode is a kernel of its own.
#include "mp_phases.cuh"

namespace {

using namespace mp;
using namespace mp::phases;

template <bool FINAL_ACT, bool RESIDUAL, int MM>
__global__ void __launch_bounds__(PT, 2)
mp_layer_fwd_kernel(const __grid_constant__ Params<MM> p) {
  __shared__ float smem[SMEM_FLOATS];
  forward<1, FINAL_ACT, RESIDUAL, false>(p, smem);
}

// GNN_Layer (both switches) or GNN_LayerLin (neither): the two layers the
// models build; the wrapper refuses the mixed cases.
template <int MM>
const void* kernel(int final_act) {
  return final_act ? (const void*)mp_layer_fwd_kernel<true, true, MM>
                   : (const void*)mp_layer_fwd_kernel<false, false, MM>;
}

}  // namespace

extern "C" long mp_layer_fwd_scratch_floats(int B, int nx, int H, int D,
                                            int V, int K) {
  return fwd_scratch_floats(1, B, nx, H, K);
}

// The blocks of the cooperative launch in mode mm, or minus a CUDA error.
extern "C" int mp_layer_fwd_grid(int final_act, int mm) {
  int blocks = 0;
  const int err = with_mode(mm, [&](auto m) {
    return cooperative_grid(kernel<decltype(m)::value>(final_act), &blocks);
  });
  return err ? -err : blocks;
}

// h, u, px, v and the weight matrices of w: float32, or bf16 in mode 2;
// out: [B, nx, H] float32; scratch: mp_layer_fwd_scratch_floats floats.
extern "C" int mp_layer_fwd(const void* h, const void* u, const void* px,
                            const void* v, const int* idx, const float* mask,
                            const void* const* w, float* out, float* scratch,
                            int B, int nx, int H, int D, int V, int K,
                            int final_act, int residual, int mm,
                            void* stream) {
  if ((final_act != 0) != (residual != 0)) return (int)cudaErrorInvalidValue;
  return with_mode(mm, [&](auto m) {
    constexpr int MM = decltype(m)::value;
    const auto p = params<MM>(h, u, px, v, idx, mask, nullptr, nullptr, w,
                              w, nullptr, nullptr, nullptr, scratch, B, nx,
                              H, D, V, K, out, nullptr, nullptr);
    return launch(kernel<MM>(final_act), p, (cudaStream_t)stream);
  });
}

#ifdef MP_PHASE_TIMES
// The card's clock at the phase boundaries of the last launch, in ns.
extern "C" int mp_layer_fwd_phase_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mp::phases::g_phase_ns,
                                   sizeof(mp::phases::g_phase_ns));
}
#endif
