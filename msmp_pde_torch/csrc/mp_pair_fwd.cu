// Fused gated message-passing pair, forward (float32, or the bf16 modes).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_pair_fwd_kernel, both variants,
// driven there by make_fused_pair._run_fwd and fused_gated_pair. With STASH
// (a template parameter) the kernel also writes gn and ln, the residuals of
// the pair's fallback backward (two single-layer backwards, mp_layer_bwd.cu):
// the combine reads the values it writes, so out is bitwise the same.
//
// For the batch, the gate layer and the main layer (both GNN_LayerLin) read
// the same inputs h [B,nx,H], u [B,nx,D], px [B,nx], v [B,nx,V]; each
// computes its layer (mp_layer.cuh) and normalizes it over each graph's
// nodes, gn for the gate and ln for the main layer, and the pair returns
// (1 - sigmoid(gn)) h + sigmoid(gn) swish(ln). The TPU kernel gathers and
// aggregates with one-hot matrices (E, G, A) on its matrix unit; here the
// gather reads idx directly and the mean walks the K neighbour slots.
//
// What bounds it on an H100: operations. At B = 16, nx = 100, K = 6,
// H = 128 the pair is ~1.1 GFLOP of float32 (the per-edge w2 product is
// half of it) against ~1.3 MB of inputs and weights.
//
// Design: the phases A-E of mp_phases.cuh with NL = 2, the same A-D that
// the pair's backward runs. One persistent cooperative kernel spreads each
// phase of the whole batch over every SM (a block per SM slot, items
// strided over the blocks, grid-wide barriers between phases), so a batch
// of any size fills the card; both layers' items share each phase. The
// intermediates live in a workspace the wrapper allocates
// (mp_pair_fwd_scratch_floats, 28 MB at batch 16), which stays in the
// 50 MB L2. The edge product runs in 3xTF32 on the tensor cores, the node
// products as plain FMAs. The grid is what the occupancy calculator fits on
// the card at once; a card that cannot run it cooperatively gets an error
// and no launch. The precision mode mm (bf16_mma.cuh: 0 float32, 1
// bfloat16, 2 bfloat16s with the inputs and weight matrices in bf16) is a
// template parameter, each mode a kernel of its own; in the bf16 modes the
// edge product is one bf16 pass on the tensor cores.
#include "mp_phases.cuh"

namespace {

using namespace mp;
using namespace mp::phases;

template <bool STASH, int MM>
__global__ void __launch_bounds__(PT, 2)
mp_pair_fwd_kernel(const __grid_constant__ Params<MM> p) {
  __shared__ float smem[SMEM_FLOATS];
  forward<2, false, false, STASH>(p, smem);
}

template <int MM>
const void* kernel(int stash) {
  return stash ? (const void*)mp_pair_fwd_kernel<true, MM>
               : (const void*)mp_pair_fwd_kernel<false, MM>;
}

}  // namespace

extern "C" long mp_pair_fwd_scratch_floats(int B, int nx, int H, int D, int V,
                                           int K) {
  return fwd_scratch_floats(2, B, nx, H, K);
}

// The blocks of the cooperative launch in mode mm, or minus a CUDA error.
extern "C" int mp_pair_fwd_grid(int stash, int mm) {
  int blocks = 0;
  const int err = with_mode(mm, [&](auto m) {
    return cooperative_grid(kernel<decltype(m)::value>(stash), &blocks);
  });
  return err ? -err : blocks;
}

// h, u, px, v and the weight matrices of wg, wl: float32, or bf16 in mode
// 2; out, and with the stash gn and ln: [B, nx, H] float32; gn = ln = null
// selects the variant without it. scratch: mp_pair_fwd_scratch_floats
// floats.
extern "C" int mp_pair_fwd(const void* h, const void* u, const void* px,
                           const void* v, const int* idx, const float* mask,
                           const void* const* wg, const void* const* wl,
                           float* out, float* gn, float* ln, float* scratch,
                           int B, int nx, int H, int D, int V, int K, int mm,
                           void* stream) {
  return with_mode(mm, [&](auto m) {
    constexpr int MM = decltype(m)::value;
    const auto p = params<MM>(h, u, px, v, idx, mask, nullptr, nullptr, wg,
                              wl, nullptr, nullptr, nullptr, scratch, B, nx,
                              H, D, V, K, out, gn, ln);
    return launch(kernel<MM>(gn != nullptr), p, (cudaStream_t)stream);
  });
}

#ifdef MP_PHASE_TIMES
// The card's clock at the phase boundaries of the last launch, in ns.
extern "C" int mp_pair_fwd_phase_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mp::phases::g_phase_ns,
                                   sizeof(mp::phases::g_phase_ns));
}
#endif
