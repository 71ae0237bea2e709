// LEM recurrent scan, forward, with or without the per-step stash.
//
// Replaces: msmp_pde_tpu/ops/lem_pallas.py::_fwd_kernel, both variants
// (stash=False for inference, stash=True under a gradient), the TPU
// counterpart of the reference's hand-written lem_cuda kernel.
//
// Per step t, for every row (node-sample) independently:
//   g  = gx_t + y @ Wy                 [R, 3H]  (g1 | g2 | zc)
//   z' = (1 - dt*s(g1)) z + dt*s(g1) tanh(zc)
//   y' = (1 - dt*s(g2)) y + dt*s(g2) tanh(zx_t + z' @ Wzz)
// and (y_T, z_T) are written; with the stash (ys, zs non-null) also every
// step's states ys[t] = y_{t+1}, zs[t] = z_{t+1} [T, N, H], which the
// backward (lem_bwd.cu) recomputes from.
//
// What bounds it on an H100: operations. At N = 1600, T = 25, H = 128 the
// two recurrent products are 5.2 GFLOP of float32 against 82 MB of gx/zx
// reads, well above the card's 20 FLOP/byte float32 ridge. The stash adds
// 41 MB of writes at N = 1600.
//
// Design (simple and right first):
// * Rows are independent, so a block owns R = 16 rows and walks all T
//   steps itself; the TPU's sequential time grid axis becomes this loop and
//   nothing crosses blocks. The ragged last tile is masked, not padded.
// * Thread j (blockDim = H) owns hidden column j: it keeps y[r][j], z[r][j]
//   for its R rows in registers for the whole scan. Shared memory holds
//   the rows of y and z' that the products broadcast to every column.
// * Wy and Wzz together are 256 KB in float32, above the 227 KB a block
//   may use. Wzz (64 KB) stays resident in shared memory; Wy (192 KB) is
//   streamed from L2 each step with coalesced read-only loads, where all
//   blocks share it.
// * Plain FMA loops, no tensor cores: wgmma/TMA and a larger row tile come
//   in a later change.
#include <cuda_runtime.h>

namespace {

constexpr int R = 16;  // rows per block

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

template <bool STASH>
__global__ void lem_fwd_kernel(const float* __restrict__ gx,
                               const float* __restrict__ zx,
                               const float* __restrict__ y0,
                               const float* __restrict__ z0,
                               const float* __restrict__ wy,
                               const float* __restrict__ wzz,
                               float* __restrict__ yT, float* __restrict__ zT,
                               float* __restrict__ ys, float* __restrict__ zs,
                               int T, int N, int H, float dt) {
  extern __shared__ float smem[];
  float* wzz_s = smem;          // [H, H]
  float* y_s = wzz_s + H * H;   // [R, H]
  float* z_s = y_s + R * H;     // [R, H]
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int H3 = 3 * H;

  for (int i = j; i < H * H; i += H) wzz_s[i] = wzz[i];
  float y[R], z[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool ok = row < N;
    y[r] = ok ? y0[(size_t)row * H + j] : 0.0f;
    z[r] = ok ? z0[(size_t)row * H + j] : 0.0f;
    y_s[r * H + j] = y[r];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* gxt = gx + (size_t)t * N * H3;
    const float* zxt = zx + (size_t)t * N * H;
    float g1[R], g2[R], gc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool ok = row < N;
      const float* gr = gxt + (size_t)row * H3;
      g1[r] = ok ? gr[j] : 0.0f;
      g2[r] = ok ? gr[H + j] : 0.0f;
      gc[r] = ok ? gr[2 * H + j] : 0.0f;
    }
    for (int k = 0; k < H; ++k) {
      const float* wk = wy + (size_t)k * H3;
      const float w1 = __ldg(wk + j);
      const float w2 = __ldg(wk + H + j);
      const float w3 = __ldg(wk + 2 * H + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float yk = y_s[r * H + k];
        g1[r] = fmaf(yk, w1, g1[r]);
        g2[r] = fmaf(yk, w2, g2[r]);
        gc[r] = fmaf(yk, w3, gc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dt1 = dt * sigm(g1[r]);
      z[r] = (1.0f - dt1) * z[r] + dt1 * tanhf(gc[r]);
      z_s[r * H + j] = z[r];
      g2[r] = dt * sigm(g2[r]);  // now dt2
      if (STASH && row0 + r < N)
        zs[((size_t)t * N + row0 + r) * H + j] = z[r];
    }
    __syncthreads();  // z' complete; every thread is done reading y_s

    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      a[r] = row < N ? zxt[(size_t)row * H + j] : 0.0f;
    }
    for (int k = 0; k < H; ++k) {
      const float w = wzz_s[k * H + j];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = fmaf(z_s[r * H + k], w, a[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[r] = (1.0f - g2[r]) * y[r] + g2[r] * tanhf(a[r]);
      y_s[r * H + j] = y[r];
      if (STASH && row0 + r < N)
        ys[((size_t)t * N + row0 + r) * H + j] = y[r];
    }
    __syncthreads();  // y' complete; every thread is done reading z_s
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < N) {
      yT[(size_t)row * H + j] = y[r];
      zT[(size_t)row * H + j] = z[r];
    }
  }
}

}  // namespace

extern "C" int lem_fwd_smem_bytes(int H) {
  return (H * H + 2 * R * H) * (int)sizeof(float);
}

// ys, zs: [T, N, H] stash outputs, or null for none.
extern "C" int lem_fwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       float* yT, float* zT, float* ys, float* zs, int T,
                       int N, int H, float dt, void* stream) {
  const int smem = lem_fwd_smem_bytes(H);
  const bool stash = ys != nullptr && zs != nullptr;
  auto kernel = stash ? lem_fwd_kernel<true> : lem_fwd_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N + R - 1) / R);
  kernel<<<grid, H, smem, (cudaStream_t)stream>>>(gx, zx, y0, z0, wy, wzz, yT,
                                                  zT, ys, zs, T, N, H, dt);
  return (int)cudaGetLastError();
}
