// Fused gated message-passing pair, forward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_pair_fwd_kernel, both variants,
// driven there by make_fused_pair._run_fwd and fused_gated_pair. With STASH
// (a template parameter) the kernel also writes gn and ln, the residuals of
// the pair's fallback backward (two single-layer backwards, mp_layer_bwd.cu):
// they are computed straight into the stash outputs instead of the scratch,
// so the combine reads the same values and out is bitwise the same.
//
// For one graph, the gate layer and the main layer (both GNN_LayerLin) read
// the same inputs h [nx,H], u [nx,D], px [nx], v [nx,V]; each computes
//   mix = u w_du + px w_dx,  s_i = h w_hi + mix + v w_v + b1,  s_j = h w_hj - mix
//   m2[i,k] = swish(swish(s_i[i] + s_j[idx[i,k]]) w2 + b2)
//   agg[i]  = sum_k mask[i,k] m2[i,k] / max(sum_k mask[i,k], 1)
//   o = swish([h, agg, v] w3 + b3) w4 + b4,   then InstanceNorm over nodes
// and the pair returns (1 - sigmoid(gn)) h + sigmoid(gn) swish(ln).
// The TPU kernel gathers and aggregates with one-hot matrices (E, G, A) on
// its matrix unit; here the gather reads idx directly and the mean walks
// the K neighbour slots.
//
// What bounds it on an H100: operations. At B = 16, nx = 100, K = 6,
// H = 128 the pair is ~1.1 GFLOP of float32 (the per-edge w2 product is
// half of it) against ~1.3 MB of inputs and weights.
//
// Design (simple and right first):
// * InstanceNorm reduces over a graph's nodes, so one block owns one
//   graph and runs gate, main, then the combine; no cross-block step.
//   Occupancy is poor by construction: a request of bucket B keeps only B
//   of the 132 SMs busy (1 at bucket 1, 16 at bucket 16). Splitting a
//   graph over a cluster of blocks is later work.
// * The per-edge tensor [nx*K, H] (307 KB per graph) does not fit in
//   shared memory, nor do the node-level intermediates beside it. They live
//   in a scratch buffer the wrapper allocates (per graph 6*nx*H + nx*K*H
//   floats), which stays in the 50 MB L2 at these sizes. Phases are
//   separated by __syncthreads(), which also orders the block's global
//   writes before its later reads.
// * Every product is one block-wide tiled GEMM (block_gemm.cuh) with plain
//   FMAs. The operand loaders (mp_layer.cuh) fuse the concatenations
//   ([h,agg,v]), the neighbour gather and the first swish; the stores fuse
//   bias, activation and mask. mix is computed once and its store adds it
//   to s_i and subtracts it from s_j, as the TPU kernel does. No tensor
//   cores yet: wgmma/TMA is later work.
#include "mp_layer.cuh"

namespace {

using namespace mp;

struct StoreEdge {  // mask[e] * swish(acc + b2)
  float* m2;
  const float *b2, *mask;
  int H;
  __device__ void operator()(int e, int n, float acc) const {
    m2[e * H + n] = swish(acc + b2[n]) * mask[e];
  }
};

// ---- one GNN_LayerLin, normalized output into o -------------------------
__device__ void layer(const LayerW& w, const float* h, const float* u,
                      const float* px, const float* v, const int* idx,
                      const float* mask, float* si, float* sj, float* m2,
                      float* agg, float* a3, float* o, int nx, int H, int D,
                      int V, int K, float (*As)[BM + 4], float (*Ws)[BN]) {
  block_gemm(nx, 2 * H, H, Mat{h, H}, HW{w.w_hi, w.w_hj, H},
             StoreSides{si, sj, w.b1, H}, As, Ws);
  block_gemm(nx, H, D + 1, MixIn{u, px, D}, MixW{w.w_du, w.w_dx, H, D},
             StoreMix{si, sj, v, w.w_v, H, V}, As, Ws);
  block_gemm(nx * K, H, H, EdgeIn{si, sj, idx, H, K}, Mat{w.w2, H},
             StoreEdge{m2, w.b2, mask, H}, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const int i = q / H, c = q % H;
    float s = 0.0f, deg = 0.0f;
    for (int k = 0; k < K; ++k) {
      s += m2[(i * K + k) * H + c];
      deg += mask[i * K + k];
    }
    agg[q] = s / fmaxf(deg, 1.0f);
  }
  __syncthreads();
  block_gemm(nx, H, 2 * H + V, UpdIn{h, agg, v, H, V}, Mat{w.w3, H},
             StoreBias{a3, w.b3, H, true}, As, Ws);
  block_gemm(nx, H, H, Mat{a3, H}, Mat{w.w4, H},
             StoreBias{o, w.b4, H, false}, As, Ws);
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
  }
  __syncthreads();
}

template <bool STASH>
__global__ void __launch_bounds__(THREADS)
mp_pair_fwd_kernel(const float* __restrict__ h, const float* __restrict__ u,
                   const float* __restrict__ px, const float* __restrict__ v,
                   const int* __restrict__ idx, const float* __restrict__ mask,
                   LayerW wg, LayerW wl, float* __restrict__ out,
                   float* __restrict__ gn_out, float* __restrict__ ln_out,
                   float* scratch, int nx, int H, int D, int V, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int b = blockIdx.x;
  const float* hb = h + (size_t)b * nx * H;
  const float* ub = u + (size_t)b * nx * D;
  const float* pxb = px + (size_t)b * nx;
  const float* vb = v + (size_t)b * nx * V;
  float* si = scratch + (size_t)b * (6 * nx + nx * K) * H;
  float* sj = si + nx * H;
  float* agg = sj + nx * H;
  float* a3 = agg + nx * H;
  float* gn = STASH ? gn_out + (size_t)b * nx * H : a3 + nx * H;
  float* ln = STASH ? ln_out + (size_t)b * nx * H : a3 + 2 * nx * H;
  float* m2 = a3 + 3 * nx * H;
  layer(wg, hb, ub, pxb, vb, idx, mask, si, sj, m2, agg, a3, gn, nx, H, D,
        V, K, As, Ws);
  layer(wl, hb, ub, pxb, vb, idx, mask, si, sj, m2, agg, a3, ln, nx, H, D,
        V, K, As, Ws);
  float* ob = out + (size_t)b * nx * H;
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const float tau = sigm(gn[q]);
    ob[q] = (1.0f - tau) * hb[q] + tau * swish(ln[q]);
  }
}

}  // namespace

// out, and with the stash gn and ln: [B, nx, H]; gn = ln = null selects
// the variant without it. scratch: B * (6 nx + nx K) H floats.
extern "C" int mp_pair_fwd(const float* h, const float* u, const float* px,
                           const float* v, const int* idx, const float* mask,
                           const void* const* wg, const void* const* wl,
                           float* out, float* gn, float* ln, float* scratch,
                           int B, int nx, int H, int D, int V, int K,
                           void* stream) {
  auto kernel = gn ? mp_pair_fwd_kernel<true> : mp_pair_fwd_kernel<false>;
  kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      h, u, px, v, idx, mask, unpack(wg), unpack(wl), out, gn, ln, scratch,
      nx, H, D, V, K);
  return (int)cudaGetLastError();
}
