// LEM recurrent scan, backward (BPTT reverse sweep), float32.
//
// Replaces: msmp_pde_tpu/ops/lem_pallas.py::_bwd_kernel, driven there by
// make_lem_scan._run_bwd.
//
// For every row independently, t = T-1 .. 0, from the forward's stash
// (ys[t] = y_{t+1}, zs[t] = z_{t+1}; y_prev = y0 at t = 0, else ys[t-1]):
//   recompute g = gx_t + y_prev Wy (s1, s2, tanh(zc)), a = zx_t + z_t Wzz
//   da  = dy dt2 (1 - tanh(a)^2),  dg2 = dy (tanh(a) - y_prev) dt s2 (1-s2)
//   dz += da Wzz^T
//   dg1 = dz (tanh(zc) - z_prev) dt s1 (1-s1),  dzc = dz dt1 (1 - tanh(zc)^2)
//   dy  = dy (1 - dt2) + [dg1 dg2 dzc] Wy^T,    dz  = dz (1 - dt1)
// and writes dgx_t = [dg1 dg2 dzc], dzx_t = da; (dy, dz) at the end are
// dy0, dz0. The weight gradients are dWy = sum_t y_prev^T dgx_t and
// dWzz = sum_t z_t^T dzx_t.
//
// What bounds it on an H100: operations. At N = 1600, T = 25, H = 128 the
// sweep's four recurrent products (recompute g and a, dz and dy) are
// 10.5 GFLOP and the two weight gradients 5.2 GFLOP of float32, against
// ~164 MB of reads and writes.
//
// Design (simple and right first):
// * The sweep: as in lem_fwd.cu, a block owns R = 16 rows and walks all T
//   steps in reverse; thread j owns hidden column j and keeps dy, dz of
//   its rows in registers. dz += da Wzz^T and dy += dg Wy^T need whole
//   rows of da and dg, so they are staged in shared memory each step.
//   Wzz (64 KB) stays in shared memory with a row pitch of H+1 floats, so
//   that both Wzz (forward product) and Wzz^T (backward product) read
//   without bank conflicts. Wy (192 KB) does not fit beside it and is
//   streamed from L2 each step twice: as Wy for the recompute, and as a
//   transposed copy Wy^T [3H, H] the wrapper makes, so that both reads are
//   coalesced.
// * The weight gradients: the TPU grid accumulates them in VMEM across its
//   sequential row tiles. Here a second launch computes them from the
//   sweep's outputs dgx, dzx and the stash as one product over all T*N
//   rows: each block takes a 64x64 output tile and a chunk of 1024 rows
//   (block_gemm.cuh) and writes its partial sum; a third launch sums the
//   chunks in a fixed order. No float atomics: bitwise repeatable.
#include "block_gemm.cuh"

namespace {

using mp::BK;
using mp::BM;
using mp::BN;
using mp::sigm;

constexpr int R = 16;        // rows per block of the sweep
constexpr int CHUNK = 1024;  // rows per block of the weight gradients

__global__ void lem_bwd_scan(const float* __restrict__ gx,
                             const float* __restrict__ zx,
                             const float* __restrict__ y0,
                             const float* __restrict__ z0,
                             const float* __restrict__ wy,
                             const float* __restrict__ wzz,
                             const float* __restrict__ ys,
                             const float* __restrict__ zs,
                             const float* __restrict__ dyT,
                             const float* __restrict__ dzT,
                             const float* __restrict__ wyT,
                             float* __restrict__ dgx, float* __restrict__ dzx,
                             float* __restrict__ dy0, float* __restrict__ dz0,
                             int T, int N, int H, float dt) {
  extern __shared__ float smem[];
  const int P = H + 1;            // Wzz row pitch
  float* wzz_s = smem;            // [H, H+1]
  float* yp_s = wzz_s + H * P;    // [R, H]  y_prev rows
  float* zc_s = yp_s + R * H;     // [R, H]  z_t rows
  float* da_s = zc_s + R * H;     // [R, H]
  float* dg_s = da_s + R * H;     // [R, 3H]
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int H3 = 3 * H;

  for (int i = j; i < H * H; i += H) wzz_s[(i / H) * P + i % H] = wzz[i];
  float dy[R], dz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool ok = row < N;
    dy[r] = ok ? dyT[(size_t)row * H + j] : 0.0f;
    dz[r] = ok ? dzT[(size_t)row * H + j] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const float* yprev = t ? ys + (size_t)(t - 1) * N * H : y0;
    const float* zprev = t ? zs + (size_t)(t - 1) * N * H : z0;
    const float* zcur = zs + (size_t)t * N * H;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool ok = row < N;
      yp_s[r * H + j] = ok ? yprev[(size_t)row * H + j] : 0.0f;
      zc_s[r * H + j] = ok ? zcur[(size_t)row * H + j] : 0.0f;
    }
    __syncthreads();

    const float* gxt = gx + (size_t)t * N * H3;
    const float* zxt = zx + (size_t)t * N * H;
    float tha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      tha[r] = row < N ? zxt[(size_t)row * H + j] : 0.0f;
    }
    for (int k = 0; k < H; ++k) {
      const float w = wzz_s[k * P + j];
#pragma unroll
      for (int r = 0; r < R; ++r) tha[r] = fmaf(zc_s[r * H + k], w, tha[r]);
    }
    float g1[R], g2[R], gc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool ok = row < N;
      const float* gr = gxt + (size_t)row * H3;
      g1[r] = ok ? gr[j] : 0.0f;
      g2[r] = ok ? gr[H + j] : 0.0f;
      gc[r] = ok ? gr[2 * H + j] : 0.0f;
      tha[r] = tanhf(tha[r]);
    }
    for (int k = 0; k < H; ++k) {
      const float* wk = wy + (size_t)k * H3;
      const float w1 = __ldg(wk + j);
      const float w2 = __ldg(wk + H + j);
      const float w3 = __ldg(wk + 2 * H + j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float yk = yp_s[r * H + k];
        g1[r] = fmaf(yk, w1, g1[r]);
        g2[r] = fmaf(yk, w2, g2[r]);
        gc[r] = fmaf(yk, w3, gc[r]);
      }
    }
    // g1 -> s1, g2 -> dt2, gc -> tanh(zc)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const float s1 = sigm(g1[r]), s2 = sigm(g2[r]);
      const float dt2 = dt * s2;
      const float da = dy[r] * dt2 * (1.0f - tha[r] * tha[r]);
      const float dg2 = dy[r] * (tha[r] - yp_s[r * H + j]) * dt * s2 * (1.0f - s2);
      da_s[r * H + j] = da;
      dg_s[r * H3 + H + j] = dg2;
      if (row < N) {
        dzx[((size_t)t * N + row) * H + j] = da;
        dgx[((size_t)t * N + row) * H3 + H + j] = dg2;
      }
      g1[r] = s1;
      g2[r] = dt2;
      gc[r] = tanhf(gc[r]);
    }
    __syncthreads();  // da rows complete

    for (int k = 0; k < H; ++k) {
      const float w = wzz_s[j * P + k];
#pragma unroll
      for (int r = 0; r < R; ++r) dz[r] = fmaf(da_s[r * H + k], w, dz[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool ok = row < N;
      const float s1 = g1[r], thz = gc[r];
      const float dt1 = dt * s1;
      const float zp = ok ? zprev[(size_t)row * H + j] : 0.0f;
      const float dg1 = dz[r] * (thz - zp) * dt * s1 * (1.0f - s1);
      const float dzc = dz[r] * dt1 * (1.0f - thz * thz);
      dg_s[r * H3 + j] = dg1;
      dg_s[r * H3 + 2 * H + j] = dzc;
      if (ok) {
        float* d = dgx + ((size_t)t * N + row) * H3;
        d[j] = dg1;
        d[2 * H + j] = dzc;
      }
      dz[r] = dz[r] * (1.0f - dt1);
    }
    __syncthreads();  // dg rows complete

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int k = 0; k < H3; ++k) {
      const float w = __ldg(wyT + (size_t)k * H + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(dg_s[r * H3 + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dy[r] = dy[r] * (1.0f - g2[r]) + acc[r];
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < N) {
      dy0[(size_t)row * H + j] = dy[r];
      dz0[(size_t)row * H + j] = dz[r];
    }
  }
}

// Weight-gradient operands over the T*N rows p = t*N + n.
struct YPrevT {  // (m, k) -> y_prev of row p0 + k, feature m0 + m
  const float *y0, *ys;
  int N, H, p0, m0;
  __device__ float operator()(int m, int k) const {
    const int p = p0 + k;
    return p < N ? y0[(size_t)p * H + m0 + m] : ys[(size_t)(p - N) * H + m0 + m];
  }
};

struct Rows {  // (k, n) -> x[p0 + k, c0 + n] of a [rows, ld] array
  const float* x;
  int ld, p0, c0;
  __device__ float operator()(int k, int n) const {
    return x[(size_t)(p0 + k) * ld + c0 + n];
  }
};

struct RowsT {  // (m, k) -> x[p0 + k, c0 + m]
  const float* x;
  int ld, p0, c0;
  __device__ float operator()(int m, int k) const {
    return x[(size_t)(p0 + k) * ld + c0 + m];
  }
};

struct StorePart {  // partial[(m0 + m) * ld + n0 + n] = acc
  float* out;
  int ld, m0, n0;
  __device__ void operator()(int m, int n, float acc) const {
    out[(size_t)(m0 + m) * ld + n0 + n] = acc;
  }
};

// One 64x64 tile of [dWy | dWzz] over one chunk of rows. Tiles of dWy
// [H, 3H] come first, then those of dWzz [H, H].
__global__ void __launch_bounds__(mp::THREADS)
lem_bwd_dw(const float* __restrict__ y0, const float* __restrict__ ys,
           const float* __restrict__ zs, const float* __restrict__ dgx,
           const float* __restrict__ dzx, float* __restrict__ partial, int T,
           int N, int H) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];
  const int rows = T * N;
  const int p0 = blockIdx.y * CHUNK;
  const int kd = min(CHUNK, rows - p0);
  const int tm = (H + BM - 1) / BM;
  const int tn_y = (3 * H + BN - 1) / BN;
  float* part = partial + (size_t)blockIdx.y * 4 * H * H;
  int tile = blockIdx.x;
  if (tile < tm * tn_y) {
    const int m0 = (tile / tn_y) * BM, n0 = (tile % tn_y) * BN;
    mp::block_gemm<true>(min(BM, H - m0), min(BN, 3 * H - n0), kd,
                         YPrevT{y0, ys, N, H, p0, m0},
                         Rows{dgx, 3 * H, p0, n0},
                         StorePart{part, 3 * H, m0, n0}, As, Ws);
  } else {
    tile -= tm * tn_y;
    const int tn_z = (H + BN - 1) / BN;
    const int m0 = (tile / tn_z) * BM, n0 = (tile % tn_z) * BN;
    mp::block_gemm<true>(min(BM, H - m0), min(BN, H - n0), kd,
                         RowsT{zs, H, p0, m0}, Rows{dzx, H, p0, n0},
                         StorePart{part + 3 * H * H, H, m0, n0}, As, Ws);
  }
}

// dWy, dWzz = sum over chunks, in order, of the partials.
__global__ void lem_bwd_reduce(const float* __restrict__ partial,
                               float* __restrict__ dwy,
                               float* __restrict__ dwzz, int chunks, int H) {
  const int n = 4 * H * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * n + i];
  if (i < 3 * H * H) dwy[i] = s;
  else dwzz[i - 3 * H * H] = s;
}

int n_chunks(int T, int N) { return (T * N + CHUNK - 1) / CHUNK; }

}  // namespace

extern "C" int lem_bwd_smem_bytes(int H) {
  return (H * (H + 1) + 6 * R * H) * (int)sizeof(float);
}

extern "C" long lem_bwd_partial_floats(int T, int N, int H) {
  return (long)n_chunks(T, N) * 4 * H * H;
}

// wyT: Wy transposed [3H, H]; partial: lem_bwd_partial_floats floats.
extern "C" int lem_bwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       const float* ys, const float* zs, const float* dyT,
                       const float* dzT, const float* wyT, float* dgx,
                       float* dzx, float* dy0, float* dz0, float* dwy,
                       float* dwzz, float* partial, int T, int N, int H,
                       float dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = lem_bwd_smem_bytes(H);
  cudaFuncSetAttribute(lem_bwd_scan,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  lem_bwd_scan<<<(N + R - 1) / R, H, smem, st>>>(
      gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, wyT, dgx, dzx, dy0, dz0, T,
      N, H, dt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tm = (H + BM - 1) / BM;
  const int tiles = tm * ((3 * H + BN - 1) / BN) + tm * ((H + BN - 1) / BN);
  const int chunks = n_chunks(T, N);
  lem_bwd_dw<<<dim3(tiles, chunks), mp::THREADS, 0, st>>>(
      y0, ys, zs, dgx, dzx, partial, T, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lem_bwd_reduce<<<(4 * H * H + 255) / 256, 256, 0, st>>>(partial, dwy, dwzz,
                                                          chunks, H);
  return (int)cudaGetLastError();
}
