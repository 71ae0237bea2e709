// One message-passing layer, backward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_bwd_kernel, driven there by
// _layer_bwd_call from make_fused_layer's custom VJP and from the gated
// pair's fallback backward (make_fused_pair.bwd).
//
// For the batch with output cotangent g [B,nx,H]: the layer's forward again,
// the InstanceNorm backward and the layer backward (the TPU kernel's
// _layer_bwd_math): dh and the 12 weight gradients. With RESIDUAL, dh
// starts from the pre-norm cotangent; with FINAL_ACT, dz4 = dxo swish'(z4)
// feeds dw4, db4 and the rest. The phases are mp_phases.cuh's, with NL = 1.
//
// What bounds it on an H100: operations. One layer forward and one layer
// backward (about twice a forward) are ~1.7 GFLOP at B = 16 against
// ~2.2 MB of inputs, cotangent and weights and ~1.2 MB of outputs.
//
// Design, as the pair's backward (mp_pair_bwd.cu): one persistent
// cooperative kernel spreads each phase of the whole batch over every SM;
// weight gradients are chunk partials over node rows summed in a fixed
// order (bitwise repeatable, no float atomics); ds_j is a gather-sum over
// the inverse neighbour list the wrapper passes.
#include "mp_phases.cuh"

namespace {

using namespace mp;
using namespace mp::phases;

template <bool FINAL_ACT, bool RESIDUAL>
__global__ void __launch_bounds__(PT, 2)
mp_layer_bwd_kernel(const __grid_constant__ Params p) {
  __shared__ float smem[SMEM_FLOATS];
  backward<1, FINAL_ACT, RESIDUAL>(p, smem);
}

// GNN_Layer (both switches) or GNN_LayerLin (neither): the two layers the
// models build; the wrapper refuses the mixed cases.
const void* kernel(int final_act) {
  return final_act ? (const void*)mp_layer_bwd_kernel<true, true>
                   : (const void*)mp_layer_bwd_kernel<false, false>;
}

}  // namespace

extern "C" long mp_layer_bwd_scratch_floats(int B, int nx, int H, int D,
                                            int V, int K) {
  return scratch_floats(1, B, nx, H, D, V, K);
}

// The blocks of the cooperative launch, or minus a CUDA error.
extern "C" int mp_layer_bwd_grid(int final_act) {
  int blocks = 0;
  const int err = cooperative_grid(kernel(final_act), &blocks);
  return err ? -err : blocks;
}

// dh: [B, nx, H]; dw: the 12 gradients, flat in parameter order and shapes;
// rev_ptr [nx + 1], rev_e [nx K]: the inverse neighbour list; scratch:
// mp_layer_bwd_scratch_floats floats.
extern "C" int mp_layer_bwd(const float* h, const float* u, const float* px,
                            const float* v, const int* idx, const float* mask,
                            const int* rev_ptr, const int* rev_e,
                            const void* const* w, const float* g, float* dh,
                            float* dw, float* scratch, int B, int nx, int H,
                            int D, int V, int K, int final_act, int residual,
                            void* stream) {
  if ((final_act != 0) != (residual != 0)) return (int)cudaErrorInvalidValue;
  const LayerW lw = unpack(w);
  const Params p{h, u, px, v, idx, mask, rev_ptr, rev_e, {lw, lw}, g, dh,
                 dw, scratch, B, nx, H, D, V, K};
  return launch(kernel(final_act), p, (cudaStream_t)stream);
}

#ifdef MP_PHASE_TIMES
// The card's clock at the phase boundaries of the last launch, in ns.
extern "C" int mp_layer_bwd_phase_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mp::phases::g_phase_ns,
                                   sizeof(mp::phases::g_phase_ns));
}
#endif
