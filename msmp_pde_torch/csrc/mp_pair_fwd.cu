// Fused gated message-passing pair, forward (float32).
//
// Replaces: msmp_pde_tpu/ops/mp_pallas.py::_pair_fwd_kernel (stash=False),
// driven there by make_fused_pair._run_fwd and fused_gated_pair.
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
// * Every product is one block-wide tiled GEMM (64x64 output tiles, depth
//   16, 4x4 outputs a thread) through shared memory, with plain FMAs. The
//   operand loaders fuse the concatenations ([h,agg,v]), the neighbour
//   gather and the first swish; the stores fuse bias, activation and mask.
//   mix is computed once and its store adds it to s_i and subtracts it
//   from s_j, as the TPU kernel does. No tensor cores yet: wgmma/TMA is
//   later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 16;

struct LayerW {
  const float *w_hi, *w_hj, *w_du, *w_dx, *w_v, *b1, *w2, *b2, *w3, *b3,
      *w4, *b4;
};

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float swish(float x) { return x * sigm(x); }

// C = A @ W over rows [0, M) and columns [0, N), reduction depth Kd.
template <class ALoad, class WLoad, class Store>
__device__ void block_gemm(int M, int N, int Kd, const ALoad& A,
                           const WLoad& W, const Store& S,
                           float (*As)[BM + 4], float (*Ws)[BN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < Kd; k0 += BK) {
#pragma unroll
        for (int i = 0; i < BM * BK / THREADS; ++i) {
          const int e = tid + i * THREADS;
          const int m = e / BK, k = e % BK;
          const int gm = m0 + m, gk = k0 + k;
          As[k][m] = (gm < M && gk < Kd) ? A(gm, gk) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < BK * BN / THREADS; ++i) {
          const int e = tid + i * THREADS;
          const int k = e / BN, n = e % BN;
          const int gk = k0 + k, gn = n0 + n;
          Ws[k][n] = (gk < Kd && gn < N) ? W(gk, gn) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = Ws[k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty * 4 + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = n0 + tx * 4 + j;
          if (gn < N) S(gm, gn, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// ---- operand loaders and stores -----------------------------------------
struct HW {  // [w_hi | w_hj]
  const float *w_hi, *w_hj;
  int H;
  __device__ float operator()(int k, int n) const {
    return n < H ? w_hi[k * H + n] : w_hj[k * H + n - H];
  }
};

struct StoreSides {  // s_i = h w_hi + b1, s_j = h w_hj
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

struct MixW {  // [w_du ; w_dx]
  const float *w_du, *w_dx;
  int H, D;
  __device__ float operator()(int k, int n) const {
    return k < D ? w_du[k * H + n] : w_dx[n];
  }
};

struct StoreMix {  // mix = u w_du + px w_dx: s_i += mix + v w_v, s_j -= mix
  float *si, *sj;
  const float *v, *w_v;
  int H, V;
  __device__ void operator()(int r, int n, float acc) const {
    float vw = 0.0f;
    for (int k = 0; k < V; ++k) vw = fmaf(v[r * V + k], w_v[k * H + n], vw);
    si[r * H + n] += acc + vw;
    sj[r * H + n] -= acc;
  }
};

struct EdgeIn {  // edge e = (i, k): swish(s_i[i] + s_j[idx[i, k]])
  const float *si, *sj;
  const int* idx;
  int H, K;
  __device__ float operator()(int e, int c) const {
    return swish(si[(e / K) * H + c] + sj[idx[e] * H + c]);
  }
};

struct Mat {
  const float* w;
  int ld;
  __device__ float operator()(int k, int n) const { return w[k * ld + n]; }
};

struct StoreEdge {  // mask[e] * swish(acc + b2)
  float* m2;
  const float *b2, *mask;
  int H;
  __device__ void operator()(int e, int n, float acc) const {
    m2[e * H + n] = swish(acc + b2[n]) * mask[e];
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

struct StoreBias {
  float* out;
  const float* b;
  int H;
  bool act;
  __device__ void operator()(int r, int n, float acc) const {
    const float x = acc + b[n];
    out[r * H + n] = act ? swish(x) : x;
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

__global__ void __launch_bounds__(THREADS)
mp_pair_fwd_kernel(const float* __restrict__ h, const float* __restrict__ u,
                   const float* __restrict__ px, const float* __restrict__ v,
                   const int* __restrict__ idx, const float* __restrict__ mask,
                   LayerW wg, LayerW wl, float* __restrict__ out,
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
  float* gn = a3 + nx * H;
  float* ln = gn + nx * H;
  float* m2 = ln + nx * H;
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

LayerW unpack(const void* const* p) {
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = static_cast<const float*>(p[i]);
  return LayerW{f[0], f[1], f[2], f[3], f[4], f[5],
                f[6], f[7], f[8], f[9], f[10], f[11]};
}

}  // namespace

extern "C" int mp_pair_fwd(const float* h, const float* u, const float* px,
                           const float* v, const int* idx, const float* mask,
                           const void* const* wg, const void* const* wl,
                           float* out, float* scratch, int B, int nx, int H,
                           int D, int V, int K, void* stream) {
  mp_pair_fwd_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      h, u, px, v, idx, mask, unpack(wg), unpack(wl), out, scratch, nx, H, D,
      V, K);
  return (int)cudaGetLastError();
}
