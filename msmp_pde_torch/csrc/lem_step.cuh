// The LEM scan on a thread-block cluster: what the forward (lem_fwd.cu) and
// the backward (lem_bwd.cu) share.
//
// A cluster of C = 4 CTAs owns RT = 64 rows (node-samples) for the whole
// scan. CTA i owns the hidden columns J_i = [i HC, (i + 1) HC), HC = H/C,
// of y, z, a and of each gate g1, g2, zc, and keeps those columns of Wy
// [H, 3H] and Wzz [H, H] in its shared memory for the whole launch, so no
// weight is read from L2 inside the step loop. The rows that every column's
// product needs (y and z in the forward, y_prev and z_t in the backward)
// live in each CTA's shared memory as full [RT, H] buffers, swizzled
// (column k of row r at k ^ ((r & 7) << 2)) so that the tensor cores' A
// fragments load without bank conflicts. A CTA writes its columns into the
// other CTAs' shared memory (distributed shared memory) between cluster
// barriers.
//
// The products run in 3xTF32 on the tensor cores (tf32_mma.cuh), which
// keeps float32's accuracy; the operands are split with integer arithmetic
// (split_tf32_int), bitwise as cvt.rna would. Both directions use the same
// gate functions, so the backward recomputes what the forward computed,
// and the same weight gather (load_weights), each storing the weights in
// the layout of its own products. Those products are two copies: the
// forward's wgmma chains want the weights split in two in shared memory
// (128 KB at H = 128), which do not fit beside the backward's buffers, so
// the backward's recompute runs mma.sync on the raw weights (the forward
// on mma.sync took 0.29 ms against wgmma's 0.19 at N = 1600 on an H100).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace lem {

using mp::mma_tf32;
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  mp::split_tf32_int(x, big, small);
}

#ifdef LEM_PHASE_TIMES
// Built with -DLEM_PHASE_TIMES (msmp_pde_torch/tools/lem_phases.py), thread
// 0 of CTA 0 adds the SM cycles of each part of a launch to g_cycles[n];
// the library's <name>_phase_cycles reads and clears them.
__device__ unsigned long long g_cycles[16];
#define LEM_PHASE_START long long lem_t0 = clock64()
#define LEM_PHASE(n)                                \
  do {                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0) {      \
      const long long now = clock64();              \
      lem::g_cycles[n] += now - lem_t0;             \
      lem_t0 = now;                                 \
    }                                               \
  } while (0)
#define LEM_PHASE_READER(name)                                            \
  extern "C" int name##_phase_cycles(unsigned long long* out) {           \
    const unsigned long long zero[16] = {};                               \
    cudaError_t e = cudaMemcpyFromSymbol(out, lem::g_cycles, sizeof(zero)); \
    if (e == cudaSuccess)                                                 \
      e = cudaMemcpyToSymbol(lem::g_cycles, zero, sizeof(zero));          \
    return (int)e;                                                        \
  }
#else
#define LEM_PHASE_START \
  do {                  \
  } while (0)
#define LEM_PHASE(n) \
  do {               \
  } while (0)
#define LEM_PHASE_READER(name)
#endif

// CTAs of a cluster. With 2, a CTA's weights split in two for the
// forward's wgmma would take 256 KB at H = 128; with 8, H/C is 12 at
// H = 96, not a tile's 8, and 64-row clusters at N = 1600 would be 200
// CTAs, two waves. (Chosen from these sizes, not measured against 2, 8.)
constexpr int C = 4;
constexpr int RT = 64;            // rows of a cluster: a wgmma tile
constexpr int SMEM_MAX = 232448;  // shared memory a block may use

// The gates' sigmoid and tanh from the hardware exp and division (__expf,
// __fdividef): a few instructions and no branch, so that a thread's many
// elements overlap (expf, tanhf and the IEEE division took 2.3x as long in
// the forward); ~1e-7 from the accurate functions.
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// ---- the cluster -----------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: every thread of the cluster arrives
// (its shared and distributed shared stores released), and later waits for
// all the others (acquiring theirs); work between the two overlaps the
// gather.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the shared address `addr` in the CTA of cluster rank `rank`
__device__ __forceinline__ uint32_t remote(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, const float (&v)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- a thread's elements in global memory ---------------------------------
// d[0..1] = src[0..1] (8-byte aligned), or zeros where !ok
__device__ __forceinline__ void ld_pair(float* d, const float* src, bool ok) {
  if (ok) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(src));
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = d[1] = 0.0f;
  }
}

template <bool STREAM>
__device__ __forceinline__ void st_pair(float* dst, float a, float b,
                                        bool ok) {
  if (!ok) return;
  if (STREAM) __stcs(reinterpret_cast<float2*>(dst), make_float2(a, b));
  else *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// ---- where a thread sits ---------------------------------------------------
// In the backward, warp (wm, wn) owns rows wm*16 + [0, 16) and the 8 hidden
// columns wn*8 + [0, 8) of J_i: one m16n8 tile of each gate and of a, so
// the gate arithmetic runs on the accumulators. Lane (g, t) owns the
// elements e = 0..3 at rows lr + 8 (e >> 1) and hidden columns col + (e & 1)
// as in the mma accumulator fragment. The forward (one warpgroup) takes
// rank, g, t and at() from it.
struct Tile {
  int H, HC, KS, WN;    // hidden, its columns a CTA, k-steps, warps a row tile
  int rank, warp, wm, wn, lane, g, t;
  int lr;   // local row of elements 0, 1 (lr + 8: elements 2, 3)
  int col;  // hidden column of elements 0, 2 (col + 1: elements 1, 3)
  __device__ explicit Tile(int H_) : H(H_) {
    HC = H / C;
    KS = H / 8;
    WN = HC / 8;
    rank = static_cast<int>(cluster_rank());
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = warp / WN;
    wn = warp % WN;
    lr = wm * 16 + g;
    col = rank * HC + wn * 8 + 2 * t;
  }
  // a row buffer's float offset of (r, k), swizzled
  __device__ int at(int r, int k) const { return r * H + (k ^ ((r & 7) << 2)); }
};

// The CTA's columns of the weights, read once: store(k, q, c, w) for each
// element w of row k, gate q (0, 1, 2: g1, g2, zc of Wy [H, 3H]; 3: Wzz
// [H, H]) and local column c of J_i. Each kernel's store puts it where its
// products read it. Consecutive threads take consecutive rows k, so a
// warp's stores spread over the banks; each keeps 8 loads in flight (the
// slices sit in L2, shared by every cluster). `threads`: the CTA's.
template <class Store>
__device__ __forceinline__ void load_weights(const float* __restrict__ wy,
                                             const float* __restrict__ wzz,
                                             int H, int rank, int threads,
                                             const Store& store) {
  constexpr int B = 8;
  const int HC = H / C, q4 = HC / 4, total = H * 4 * q4;  // float4s
  for (int i0 = threadIdx.x; i0 < total; i0 += B * threads) {
    float4 v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * threads;
      if (i >= total) break;
      const int k = i % H, c = i / H, q = c / q4;
      const int j = rank * HC + (c % q4) * 4;
      v[b] = __ldg(reinterpret_cast<const float4*>(
          q < 3 ? wy + (size_t)k * 3 * H + q * H + j
                : wzz + (size_t)k * H + j));
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * threads;
      if (i >= total) break;
      const int k = i % H, c = i / H, q = c / q4, jj = (c % q4) * 4;
      store(k, q, jj, v[b].x);
      store(k, q, jj + 1, v[b].y);
      store(k, q, jj + 2, v[b].z);
      store(k, q, jj + 3, v[b].w);
    }
  }
}

// Rows [row0, row0 + RT) of x [N, H] into the swizzled buffer, with
// cp.async (wait with cp_async_wait_all); rows past N read as zeros.
__device__ inline void load_rows(float* buf, const float* __restrict__ x,
                                 int row0, int N, const Tile& p) {
  const int per_row = p.H / 4;
  for (int i = threadIdx.x; i < RT * per_row; i += blockDim.x) {
    const int r = i / per_row, k = (i % per_row) * 4;
    const bool ok = row0 + r < N;
    cp_async16(smem_addr(buf + p.at(r, k)),
               x + (size_t)(ok ? row0 + r : 0) * p.H + k, ok);
  }
}

// ---- launching a cluster ---------------------------------------------------
// cudaFuncSetAttribute once per process and device (bit d of *done)
inline cudaError_t allow_smem(const void* kernel, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int ctas, int threads, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of C CTAs of `threads` threads and `smem` bytes that the card
// can hold at once (0: it cannot schedule one), or -(CUDA error)
inline int max_clusters(const void* kernel, unsigned long long* done,
                        int threads, int smem) {
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ClusterLaunch l(C, threads, smem, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace lem

// ---- the width-generic route (hidden 164) ---------------------------------
// The cluster layout above needs H/C to be a multiple of 8 and holds a CTA's
// quarter of the weights in shared memory; at H = 164, H/C = 41 and the
// forward would need 299,136 bytes a CTA. This route has no cluster: a block
// of threads(H) = 32 cdiv(H, 32) threads owns GR rows and every hidden
// column, thread j < H the column j of each of its rows, and reads Wy and
// Wzz (in the backward also their transposes) from L2 at each step: 430 KB
// at H = 164, which every block shares, so they stay L2-resident. The rows
// a product needs live in shared memory k-major, X[k GP + r] (row r of
// column k), so that one k's GR values are four 16-byte broadcasts; the
// pitch GP = GR + 4 spreads a warp's column stores over the banks. The
// products are float32 FMAs on the CUDA cores, in k order.
namespace lem {
namespace gen {

constexpr int GR = 16;       // rows a block
constexpr int GP = GR + 4;   // the pitch of a k-major row buffer, floats
constexpr int MAX_H = 256;   // threads(H) <= __launch_bounds__

__host__ __device__ constexpr int threads(int H) {
  return (H + 31) / 32 * 32;
}

// acc[q][r] += sum over k < K of X[k GP + r] W[k ld + q qs + j]. Eight
// k-steps unrolled keep 8 NQ weight loads in flight a thread: the loop is
// bound by L2's latency (a trial build unrolled twice and four times was
// slower on an H100).
template <int NQ>
__device__ __forceinline__ void product(float (&acc)[NQ][GR], const float* X,
                                        const float* __restrict__ W, int ld,
                                        int qs, int j, int K) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float w[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      w[q] = __ldg(W + (size_t)k * ld + q * qs + j);
    const float4* x4 = reinterpret_cast<const float4*>(X + k * GP);
#pragma unroll
    for (int v = 0; v < GR / 4; ++v) {
      const float4 x = x4[v];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc[q][4 * v] = fmaf(x.x, w[q], acc[q][4 * v]);
        acc[q][4 * v + 1] = fmaf(x.y, w[q], acc[q][4 * v + 1]);
        acc[q][4 * v + 2] = fmaf(x.z, w[q], acc[q][4 * v + 2]);
        acc[q][4 * v + 3] = fmaf(x.w, w[q], acc[q][4 * v + 3]);
      }
    }
  }
}

// v[r] = x[row0 + r][j] of x [N, ld] (0 for rows past N)
__device__ __forceinline__ void load_col(float (&v)[GR],
                                         const float* __restrict__ x,
                                         int row0, int N, int ld, int j) {
#pragma unroll
  for (int r = 0; r < GR; ++r)
    v[r] = row0 + r < N ? x[(size_t)(row0 + r) * ld + j] : 0.0f;
}

// x[row0 + r][j] = v[r] for the rows below N
__device__ __forceinline__ void store_col(float* __restrict__ x,
                                          const float (&v)[GR], int row0,
                                          int N, int ld, int j) {
#pragma unroll
  for (int r = 0; r < GR; ++r)
    if (row0 + r < N) x[(size_t)(row0 + r) * ld + j] = v[r];
}

// column k = j of a k-major row buffer
__device__ __forceinline__ void put_col(float* X, const float (&v)[GR],
                                        int j) {
  float4* x4 = reinterpret_cast<float4*>(X + j * GP);
#pragma unroll
  for (int i = 0; i < GR / 4; ++i)
    x4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Blocks of `threads` threads and `smem` bytes that the card holds at once
// (0: none), or -(CUDA error): the generic route's counterpart of
// max_clusters, a "cluster" of one block.
inline int max_blocks(const void* kernel, unsigned long long* done,
                      int threads, int smem) {
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, per_sm = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

}  // namespace gen

// The route of each hidden width: the clusters at 96 and 128, the generic
// route at 164 (MSGMP-PDE's); no other width is taken.
inline bool cluster_width(int H) { return H == 96 || H == 128; }
inline bool generic_width(int H) { return H == 164; }

}  // namespace lem
