// Block-wide tiled float32 GEMM through shared memory, used by the LEM
// backward (lem_bwd.cu); its activations and weight loaders (swish, sigm,
// Mat, MatT) also serve the message-passing phases (mp_phases.cuh).
//
// block_gemm(M, N, Kd, A, W, S) computes C = A @ W over rows [0, M) and
// columns [0, N) with reduction depth Kd, in 64x64 output tiles of depth
// 16, 4x4 outputs a thread, plain FMAs. The operands come from loader
// functors A(m, k) and W(k, n), so that a caller fuses gathers,
// concatenations and activations into the loads; each result goes to the
// store functor S(m, n, acc). The sum over k runs in a fixed order, so a
// result is bitwise repeatable. With A_BY_M the A tile is loaded with
// consecutive threads on consecutive m: coalesced when A(m, k) lies
// contiguous in m, as for the transposed operand of a weight gradient
// (X^T @ dY).
#pragma once
#include <cuda_runtime.h>

namespace mp {

constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 16;

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float swish(float x) { return x * sigm(x); }
__device__ __forceinline__ float dswish(float x) {
  const float s = sigm(x);
  return s * (1.0f + x * (1.0f - s));
}

struct Mat {  // row-major w[k, n] with leading dimension ld
  const float* w;
  int ld;
  __device__ float operator()(int k, int n) const { return w[k * ld + n]; }
};

struct MatT {  // the transpose of row-major w: (k, n) -> w[n, k]
  const float* w;
  int ld;
  __device__ float operator()(int k, int n) const { return w[n * ld + k]; }
};

template <bool A_BY_M = false, class ALoad, class WLoad, class Store>
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
          const int m = A_BY_M ? e % BM : e / BK;
          const int k = A_BY_M ? e / BM : e % BK;
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

}  // namespace mp
