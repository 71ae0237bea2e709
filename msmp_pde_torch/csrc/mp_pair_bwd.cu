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
// The layer backward is mp_pallas.py::_layer_bwd_math:
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

template <class F>
struct Tr {  // the transpose of a loader: (a, b) -> f(b, a)
  F f;
  __device__ float operator()(int a, int b) const { return f(b, a); }
};

struct SwishIn {  // swish of row-major pre-activations
  const float* z;
  int ld;
  __device__ float operator()(int r, int c) const { return swish(z[r * ld + c]); }
};

struct Store {  // out[m, n] = acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const { out[m * ld + n] = acc; }
};

struct StoreAdd {  // out[m, n] += acc
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float acc) const { out[m * ld + n] += acc; }
};

struct StoreDeriv {  // out[m, n] = acc * swish'(z[m, n])
  float* out;
  const float* z;
  int ld;
  __device__ void operator()(int m, int n, float acc) const {
    out[m * ld + n] = acc * dswish(z[m * ld + n]);
  }
};

struct StoreDm0 {  // dm0[e, n] = acc * swish'(s_i[i] + s_j[idx[e]])
  float* dm0;
  const float *si, *sj;
  const int* idx;
  int H, K;
  __device__ void operator()(int e, int n, float acc) const {
    dm0[e * H + n] = acc * dswish(si[(e / K) * H + n] + sj[idx[e] * H + n]);
  }
};

struct StoreDhDagg {  // columns [0, H) add into dh, [H, 2H) set dagg
  float *dh, *dagg;
  int H;
  __device__ void operator()(int r, int n, float acc) const {
    if (n < H) dh[r * H + n] += acc;
    else dagg[r * H + n - H] = acc;
  }
};

struct StoreSplit {  // columns [0, H) into a, [H, 2H) into b, each [., H]
  float *a, *b;
  int H;
  __device__ void operator()(int m, int n, float acc) const {
    if (n < H) a[m * H + n] = acc;
    else b[m * H + n - H] = acc;
  }
};

struct Cat2 {  // row r of [a | b], each [., H]
  const float *a, *b;
  int H;
  __device__ float operator()(int r, int c) const {
    return c < H ? a[r * H + c] : b[r * H + c - H];
  }
};

struct HWT {  // [w_hi^T ; w_hj^T]
  const float *w_hi, *w_hj;
  int H;
  __device__ float operator()(int k, int n) const {
    return k < H ? w_hi[n * H + k] : w_hj[n * H + k - H];
  }
};

struct Diff {  // ds_i - ds_j
  const float *a, *b;
  int H;
  __device__ float operator()(int k, int n) const {
    return a[k * H + n] - b[k * H + n];
  }
};

struct Graph {  // one graph's inputs
  const float *h, *u, *px, *v;
  const int* idx;
  const float* mask;
  const int *rev_ptr, *rev_e;  // inverse neighbour list
  int nx, H, D, V, K;
};

struct Bufs {  // one graph's scratch
  float *si, *sj, *agg, *z3, *xo, *dxo, *dz3, *dagg, *dsi, *dsj, *z2, *dm0,
      *rs;
};

// Offsets of the 12 gradients in one layer's slice, in the 12-tuple order.
struct GradOff {
  int hi, hj, du, dx, v, b1, w2, b2, w3, b3, w4, b4, total;
  __host__ __device__ GradOff(int H, int D, int V) {
    hi = 0; hj = hi + H * H; du = hj + H * H; dx = du + D * H;
    v = dx + H; b1 = v + V * H; w2 = b1 + H; b2 = w2 + H * H;
    w3 = b2 + H; b3 = w3 + (2 * H + V) * H; w4 = b3 + H; b4 = w4 + H * H;
    total = b4 + H;
  }
};

__host__ __device__ inline long scratch_floats(int nx, int H, int D, int V,
                                               int K) {
  return 13L * nx * H + 2L * nx * K * H + H + (nx + 1) + nx * K;
}

// Column sums of a [rows, H] buffer, each in row order.
__device__ void colsum(const float* x, int rows, int H, float* out) {
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += x[r * H + c];
    out[c] = s;
  }
}

// One GNN_LayerLin forward; keeps s_i, s_j, z2, agg, z3 and writes the
// normalized output into xo and its rsqrt factors into rs. The arithmetic
// is mp_pair_fwd.cu's, operation for operation.
__device__ void layer_fwd(const LayerW& w, const Graph& G, const Bufs& s,
                          float (*As)[BM + 4], float (*Ws)[BN]) {
  const int nx = G.nx, H = G.H, K = G.K;
  block_gemm(nx, 2 * H, H, Mat{G.h, H}, HW{w.w_hi, w.w_hj, H},
             StoreSides{s.si, s.sj, w.b1, H}, As, Ws);
  block_gemm(nx, H, G.D + 1, MixIn{G.u, G.px, G.D},
             MixW{w.w_du, w.w_dx, H, G.D},
             StoreMix{s.si, s.sj, G.v, w.w_v, H, G.V}, As, Ws);
  block_gemm(nx * K, H, H, EdgeIn{s.si, s.sj, G.idx, H, K}, Mat{w.w2, H},
             StoreBias{s.z2, w.b2, H, false}, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const int i = q / H, c = q % H;
    float sum = 0.0f, deg = 0.0f;
    for (int k = 0; k < K; ++k) {
      sum += swish(s.z2[(i * K + k) * H + c]) * G.mask[i * K + k];
      deg += G.mask[i * K + k];
    }
    s.agg[q] = sum / fmaxf(deg, 1.0f);
  }
  __syncthreads();
  block_gemm(nx, H, 2 * H + G.V, UpdIn{G.h, s.agg, G.v, H, G.V},
             Mat{w.w3, H}, StoreBias{s.z3, w.b3, H, false}, As, Ws);
  block_gemm(nx, H, H, SwishIn{s.z3, H}, Mat{w.w4, H},
             StoreBias{s.xo, w.b4, H, false}, As, Ws);
  float* o = s.xo;
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
    s.rs[c] = rs;
  }
  __syncthreads();
}

// The layer's backward from the cotangent of its normalized output, right
// after layer_fwd of the same layer: adds into dh and writes the 12
// weight gradients of this graph into dw.
__device__ void layer_bwd(const LayerW& w, const float* cot, const Graph& G,
                          const Bufs& s, float* dh, float* dw,
                          float (*As)[BM + 4], float (*Ws)[BN]) {
  const int nx = G.nx, H = G.H, K = G.K, D = G.D, V = G.V;
  const GradOff o(H, D, V);
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float mg = 0.0f, mgx = 0.0f;
    for (int r = 0; r < nx; ++r) {
      mg += cot[r * H + c];
      mgx += cot[r * H + c] * s.xo[r * H + c];
    }
    mg /= nx;
    mgx /= nx;
    float db4 = 0.0f;
    for (int r = 0; r < nx; ++r) {
      const float d = s.rs[c] * (cot[r * H + c] - mg - s.xo[r * H + c] * mgx);
      s.dxo[r * H + c] = d;
      db4 += d;
    }
    dw[o.b4 + c] = db4;
  }
  __syncthreads();
  block_gemm<true>(H, H, nx, Tr<SwishIn>{{s.z3, H}}, Mat{s.dxo, H},
                   Store{dw + o.w4, H}, As, Ws);
  block_gemm(nx, H, H, Mat{s.dxo, H}, MatT{w.w4, H},
             StoreDeriv{s.dz3, s.z3, H}, As, Ws);
  colsum(s.dz3, nx, H, dw + o.b3);
  block_gemm<true>(2 * H + V, H, nx, Tr<UpdIn>{{G.h, s.agg, G.v, H, V}},
                   Mat{s.dz3, H}, Store{dw + o.w3, H}, As, Ws);
  block_gemm(nx, 2 * H, H, Mat{s.dz3, H}, MatT{w.w3, H},
             StoreDhDagg{dh, s.dagg, H}, As, Ws);
  // dz2 over z2, in place
  for (int q = threadIdx.x; q < nx * K * H; q += blockDim.x) {
    const int e = q / H, i = e / K, c = q % H;
    float deg = 0.0f;
    for (int k = 0; k < K; ++k) deg += G.mask[i * K + k];
    s.z2[q] = s.dagg[i * H + c] * (G.mask[e] / fmaxf(deg, 1.0f)) *
              dswish(s.z2[q]);
  }
  __syncthreads();
  colsum(s.z2, nx * K, H, dw + o.b2);
  block_gemm<true>(H, H, nx * K, Tr<EdgeIn>{{s.si, s.sj, G.idx, H, K}},
                   Mat{s.z2, H}, Store{dw + o.w2, H}, As, Ws);
  block_gemm(nx * K, H, H, Mat{s.z2, H}, MatT{w.w2, H},
             StoreDm0{s.dm0, s.si, s.sj, G.idx, H, K}, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const int i = q / H, c = q % H;
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < K; ++k) a += s.dm0[(i * K + k) * H + c];
    for (int p = G.rev_ptr[i]; p < G.rev_ptr[i + 1]; ++p) {
      const int e = G.rev_e[p];
      b += s.dm0[e * H + c] * G.mask[e];
    }
    s.dsi[q] = a;
    s.dsj[q] = b;
  }
  __syncthreads();
  colsum(s.dsi, nx, H, dw + o.b1);
  block_gemm(nx, H, 2 * H, Cat2{s.dsi, s.dsj, H}, HWT{w.w_hi, w.w_hj, H},
             StoreAdd{dh, H}, As, Ws);
  // [dw_hi | dw_hj] and [dw_du ; dw_dx] are adjacent in the slice
  block_gemm<true>(H, 2 * H, nx, MatT{G.h, H}, Cat2{s.dsi, s.dsj, H},
                   StoreSplit{dw + o.hi, dw + o.hj, H}, As, Ws);
  block_gemm<true>(D + 1, H, nx, Tr<MixIn>{{G.u, G.px, D}},
                   Diff{s.dsi, s.dsj, H}, Store{dw + o.du, H}, As, Ws);
  block_gemm<true>(V, H, nx, MatT{G.v, V}, Mat{s.dsi, H},
                   Store{dw + o.v, H}, As, Ws);
}

// The inverse neighbour list of the graph: for each node n, the valid
// edges e with idx[e] = n, in increasing e.
__device__ void build_inverse(const Graph& G, int* rev_ptr, int* rev_e) {
  const int nE = G.nx * G.K;
  for (int n = threadIdx.x; n < G.nx; n += blockDim.x) {
    int c = 0;
    for (int e = 0; e < nE; ++e) c += (G.mask[e] != 0.0f && G.idx[e] == n);
    rev_ptr[n + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    rev_ptr[0] = 0;
    for (int n = 0; n < G.nx; ++n) rev_ptr[n + 1] += rev_ptr[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < G.nx; n += blockDim.x) {
    int p = rev_ptr[n];
    for (int e = 0; e < nE; ++e)
      if (G.mask[e] != 0.0f && G.idx[e] == n) rev_e[p++] = e;
  }
  __syncthreads();
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
  layer_fwd(wg, G, s, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) gn[q] = s.xo[q];
  __syncthreads();
  // pass 2: main forward, combine backward, main backward
  layer_fwd(wl, G, s, As, Ws);
  for (int q = threadIdx.x; q < nx * H; q += blockDim.x) {
    const float tau = sigm(gn[q]), ln = s.xo[q], gq = gb[q];
    cot[q] = gq * tau * dswish(ln);
    dgn[q] = gq * (swish(ln) - G.h[q]) * tau * (1.0f - tau);
    dhb[q] = gq * (1.0f - tau);
  }
  __syncthreads();
  layer_bwd(wl, cot, G, s, dhb, dwl, As, Ws);
  // pass 3: gate forward again, gate backward
  layer_fwd(wg, G, s, As, Ws);
  layer_bwd(wg, dgn, G, s, dhb, dwg, As, Ws);
}

// dw[i] = sum over graphs b, in order, of partial[b, i].
__global__ void reduce_graphs(const float* __restrict__ partial,
                              float* __restrict__ dw, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += partial[(size_t)b * n + i];
  dw[i] = s;
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
  reduce_graphs<<<(n + 255) / 256, 256, 0, st>>>(partial, dw, B, n);
  return (int)cudaGetLastError();
}
