// Fused gated message-passing pair, backward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_pair_bwd_kernel, driven there
// by _pair_bwd_call from make_fused_pair's custom VJP.
//
// For the batch with output cotangent g [B,nx,H]: both layers' forwards
// again (gate -> gn, main -> ln, each normalized over its graph's nodes),
// the combine's backward
//   dln = g tau swish'(ln),  dgn = g (swish(ln) - h) tau (1 - tau),
//   dh = g (1 - tau),   tau = sigmoid(gn),
// each layer's InstanceNorm backward and layer backward
// (mp_pallas.py::_layer_bwd_math): dh and the 24 weight gradients, gate's
// 12 then main's. The phases are mp_phases.cuh's, with NL = 2.
//
// What bounds it on an H100: operations. Two layer forwards and two layer
// backwards are ~3.5 GFLOP of float32 at B = 16, nx = 100, K = 6, H = 128,
// against ~2.1 MB of inputs, cotangent and weights and ~1.6 MB of outputs.
//
// Design:
// * The TPU kernel runs graph after graph on one core, recomputing the gate
//   layer's forward after the main layer's backward so that only one
//   layer's intermediates live in VMEM. Here one persistent cooperative
//   kernel spreads each phase of the whole batch over every SM (a block per
//   SM slot, items strided over the blocks, grid-wide barriers between
//   phases). Both layers run in the same phases, each with its own
//   intermediates in the workspace (L2-resident at E1), so the gate's
//   forward runs once and the two layers' items fill the card together.
// * The weight gradients are split over chunks of node rows that the
//   shapes fix, one partial a chunk, summed in chunk order by the last
//   phase: bitwise repeatable at any grid size, no float atomics.
// * ds_j, the transpose of the neighbour gather, is a gather-sum over the
//   inverse neighbour list the wrapper passes (ops/mp_layer.py::
//   inverse_neighbors), in increasing edge order.
// * The grid is what the occupancy calculator fits on the card at once; a
//   card that cannot run it cooperatively gets an error and no launch.
#include "mp_phases.cuh"

namespace {

using namespace mp;
using namespace mp::phases;

__global__ void __launch_bounds__(PT, 2)
mp_pair_bwd_kernel(const __grid_constant__ Params p) {
  __shared__ float smem[SMEM_FLOATS];
  backward<2, false, false>(p, smem);
}

}  // namespace

extern "C" long mp_pair_bwd_scratch_floats(int B, int nx, int H, int D, int V,
                                           int K) {
  return scratch_floats(2, B, nx, H, D, V, K);
}

// The blocks of the cooperative launch, or minus a CUDA error.
extern "C" int mp_pair_bwd_grid() {
  int blocks = 0;
  const int err = cooperative_grid((const void*)mp_pair_bwd_kernel, &blocks);
  return err ? -err : blocks;
}

// dh: [B, nx, H]; dw: [gate 12 | main 12] gradients, flat in parameter
// order and shapes; rev_ptr [nx + 1], rev_e [nx K]: the inverse neighbour
// list; scratch: mp_pair_bwd_scratch_floats floats.
extern "C" int mp_pair_bwd(const float* h, const float* u, const float* px,
                           const float* v, const int* idx, const float* mask,
                           const int* rev_ptr, const int* rev_e,
                           const void* const* wg, const void* const* wl,
                           const float* g, float* dh, float* dw,
                           float* scratch, int B, int nx, int H, int D, int V,
                           int K, void* stream) {
  const Params p{h, u, px, v, idx, mask, rev_ptr, rev_e,
                 {unpack(wg), unpack(wl)}, g, dh, dw, scratch,
                 B, nx, H, D, V, K};
  return launch((const void*)mp_pair_bwd_kernel, p, (cudaStream_t)stream);
}

#ifdef MP_PHASE_TIMES
// The card's clock at the phase boundaries of the last launch, in ns.
extern "C" int mp_pair_bwd_phase_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mp::phases::g_phase_ns,
                                   sizeof(mp::phases::g_phase_ns));
}
#endif
