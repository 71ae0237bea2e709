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
// What bounds it on an H100: operations, and the recurrence. At N = 1600,
// T = 25, H = 128 the two recurrent products are 5.2 GFLOP of float32
// against 82 MB of gx/zx reads (41 MB more of stash writes), above the
// card's ridge; and every step needs the whole previous step of its rows.
//
// Design (lem_step.cuh): a cluster of C = 4 CTAs owns 64 rows for all T
// steps and keeps Wy and Wzz resident, a quarter of the columns in each CTA,
// split once into TF32 (big, small) as wgmma's B operands (128 KB at
// H = 128), so no weight leaves shared memory inside the loop. A CTA is one
// warpgroup: each step it runs g = y Wy for all its columns as one
// 64 x 3HC wgmma chain (m64n96k8 at H = 128; 3 per k-step for 3xTF32, the
// rows split in registers) and a = z' Wzz as one 64 x HC chain, so each
// thread holds g1, g2, zc and a of the same elements. A step is two
// half-steps: g, then z' of the CTA's columns, written into its own z rows
// and copied in 16-byte pieces into the other CTAs' (distributed shared
// memory); a cluster barrier; a, then y' likewise; a second barrier. Each
// buffer has one writer phase and one reader phase between the two
// barriers, so one copy suffices; the stash stores run between a barrier's
// arrive and wait. gx_{t+1} and zx_{t+1} do not depend on the recurrence:
// each thread loads its elements of them while step t computes (streaming
// loads and stores). At N = 1600 the 25 clusters are one wave of 100 CTAs.
// tools/lem_phases.py splits a launch: the products take about half, the
// gates and the exchanges (bounded by distributed shared memory) most of
// the rest.
#include "lem_step.cuh"

namespace {

using lem::C;
using lem::RT;
using mp::pin;
using mp::wgmma_tf32;

constexpr int THREADS = 128;  // one warpgroup a CTA: the RT = 64 rows

// Where lem::load_weights puts the CTA's columns of Wy and Wzz: split in
// TF32 (big, small), as the B operands of wgmma. For k-step ks and part h,
// 32 HC words, the g tile (its 3 HC rows n = q HC + c: gate q, local
// column c) then the a tile (HC rows n = c); a row holds the 8 k of the
// step in two 16-byte halves. K-major core matrices of 8 rows x 16 bytes,
// the halves 128 bytes apart, the 8-row groups 256 (mp::wgmma_desc).
template <int HC>
struct StoreSplit {
  uint32_t* wf;
  __device__ void operator()(int k, int q, int c, float w) const {
    const int n = (q < 3 ? q * HC : 0) + c, ks = k >> 3, kk = k & 7;
    const int off = (q < 3 ? 0 : 24 * HC) +
                    (((n >> 3) * 2 + (kk >> 2)) * 8 + (n & 7)) * 4 + (kk & 3);
    uint32_t big, small;
    lem::split_tf32(w, big, small);
    wf[(ks * 2) * 32 * HC + off] = big;
    wf[(ks * 2 + 1) * 32 * HC + off] = small;
  }
};

// d = rows[the cluster's 64 rows, :] @ the B tile of desc0 over k in
// [0, H), in 3xTF32 with wgmma (N = 3 HC: g1 g2 zc; N = HC: a). Each warp
// splits its 16 rows' A fragment in registers; the weights were split at
// load. KB k-steps go out as one group of 3 KB wgmma, whose registers are
// reused once the group after it is issued and it has completed. The first
// wgmma overwrites d, so no other instruction writes d while the wgmmas
// are in flight.
template <int N, int HC>
__device__ __forceinline__ void product_wg(float (&d)[N / 2], const float* rows,
                                        uint64_t desc0, int lr, int t) {
  constexpr int H = C * HC, KS = H / 8, KB = 2;
  constexpr uint32_t STEP = 32 * HC * 4 * 2 / 16;  // a k-step's descriptors
  constexpr uint32_t PART = 32 * HC * 4 / 16;      // big to small
  const float* ra = rows + lr * H;
  const float* rb = ra + 8 * H;
  const int sw = (lr & 7) << 2;
  uint32_t ab[2][KB][4], as[2][KB][4];
#pragma unroll 1
  for (int ks0 = 0; ks0 < KS; ks0 += 2 * KB) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const int k = 8 * (ks0 + b * KB + i) + t;
        lem::split_tf32(ra[k ^ sw], ab[b][i][0], as[b][i][0]);
        lem::split_tf32(rb[k ^ sw], ab[b][i][1], as[b][i][1]);
        lem::split_tf32(ra[(k + 4) ^ sw], ab[b][i][2], as[b][i][2]);
        lem::split_tf32(rb[(k + 4) ^ sw], ab[b][i][3], as[b][i][3]);
      }
      mp::wgmma_fence();
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const uint64_t big = desc0 + (ks0 + b * KB + i) * STEP;
        wgmma_tf32<N>(d, as[b][i], big, ks0 + b + i > 0);
        wgmma_tf32<N>(d, ab[b][i], big + PART, 1);
        wgmma_tf32<N>(d, ab[b][i], big, 1);
      }
      mp::wgmma_commit();
      mp::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < KB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pin(ab[b ^ 1][i][e]);
          pin(as[b ^ 1][i][e]);
        }
    }
  }
  mp::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pin(d[i]);
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pin(ab[b][i][e]);
        pin(as[b][i][e]);
      }
}

// This CTA's columns of a row buffer, written locally, into the same place
// of the other CTAs' buffers: 16-byte pieces (the swizzle keeps 4
// consecutive columns together).
template <int HC>
__device__ __forceinline__ void send_own(const float* buf, int rank,
                                         const lem::Tile& p) {
  constexpr int PIECES = RT * HC / 4;
  const uint32_t base = lem::smem_addr(buf);
  for (int i = threadIdx.x; i < (C - 1) * PIECES; i += THREADS) {
    const int d = i / PIECES, pc = i % PIECES;
    const int r = pc / (HC / 4), k = rank * HC + (pc % (HC / 4)) * 4;
    const int off = p.at(r, k);
    const float4 v = *reinterpret_cast<const float4*>(buf + off);
    const float f[4] = {v.x, v.y, v.z, v.w};
    lem::st_cluster(lem::remote(base + 4 * off, d < rank ? d : d + 1), f);
  }
}

template <int HC, bool STASH>
__global__ void __launch_bounds__(THREADS, 1)
lem_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ zx,
               const float* __restrict__ y0, const float* __restrict__ z0,
               const float* __restrict__ wy, const float* __restrict__ wzz,
               float* __restrict__ yT, float* __restrict__ zT,
               float* __restrict__ ys, float* __restrict__ zs, int T, int N,
               float dt) {
  constexpr int H = C * HC, WN = HC / 8, NE = HC / 2;  // NE elements a thread
  extern __shared__ float4 smem4[];
  LEM_PHASE_START;
  const lem::Tile p(H);
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem4);  // 8 H HC words
  float* y_s = reinterpret_cast<float*>(wf + 8 * H * HC);  // [RT, H]
  float* z_s = y_s + RT * H;                               // [RT, H]
  const int rank = p.rank, t = p.t;
  const int lr = (threadIdx.x >> 5) * 16 + p.g;  // warp w: rows 16 w + ..
  const int row0 = (blockIdx.x / C) * RT;
  const size_t H3 = 3 * (size_t)H, NH = (size_t)N * H;

  lem::load_weights(wy, wzz, H, rank, THREADS, StoreSplit<HC>{wf});
  lem::load_rows(y_s, y0, row0, N, p);
  // element e = cb*4 + rr*2 + cc: local row lr + 8 rr, CTA column
  // cb*8 + 2t + cc, as in the wgmma accumulators (gate q at q*NE + e)
  int grow[2];
  bool ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    grow[rr] = row0 + lr + 8 * rr;
    ok[rr] = grow[rr] < N;
  }
  auto col = [&](int cb) { return rank * HC + cb * 8 + 2 * t; };
  float y[NE], z[NE];
#pragma unroll
  for (int cb = 0; cb < WN; ++cb)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t i = (size_t)grow[rr] * H + col(cb);
      lem::ld_pair(y + cb * 4 + rr * 2, y0 + i, ok[rr]);
      lem::ld_pair(z + cb * 4 + rr * 2, z0 + i, ok[rr]);
    }
  float pg[3 * NE], pa[NE];  // gx_t, zx_t of this thread's elements
  auto fetch_g = [&](int s) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int cb = 0; cb < WN; ++cb)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::ld_pair(pg + q * NE + cb * 4 + rr * 2,
                       gx + s * N * H3 + grow[rr] * H3 + q * H + col(cb),
                       ok[rr]);
  };
  auto fetch_a = [&](int s) {
#pragma unroll
    for (int cb = 0; cb < WN; ++cb)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        lem::ld_pair(pa + cb * 4 + rr * 2,
                     zx + s * NH + (size_t)grow[rr] * H + col(cb), ok[rr]);
  };
  if (T > 0) {
    fetch_g(0);
    fetch_a(0);
  }
  lem::cp_async_wait_all();
  // the weights, written by this CTA's threads, are read by wgmma
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  lem::cluster_sync();  // every CTA has started; the y rows are in
  LEM_PHASE(0);

  const uint32_t wf_addr = lem::smem_addr(wf);
  const uint64_t desc_g = mp::wgmma_desc(wf_addr);
  const uint64_t desc_a = mp::wgmma_desc(wf_addr + 24 * HC * 4);
  // this thread's elements (cb, rr) in a row buffer: float2 at at(cb, rr)
  auto at = [&](int cb, int rr) { return p.at(lr + 8 * rr, col(cb)); };
  for (int s = 0; s < T; ++s) {
    float g[3 * NE];
    product_wg<3 * HC, HC>(g, y_s, desc_g, lr, t);
#pragma unroll
    for (int i = 0; i < 3 * NE; ++i) g[i] += pg[i];
    if (s + 1 < T) fetch_g(s + 1);
    LEM_PHASE(1);
    float dt2[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float dt1 = dt * lem::sigm(g[e]);
      z[e] = (1.0f - dt1) * z[e] + dt1 * lem::tanh_(g[2 * NE + e]);
      dt2[e] = dt * lem::sigm(g[NE + e]);
    }
#pragma unroll
    for (int cb = 0; cb < WN; ++cb)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(z_s + at(cb, rr)) =
            make_float2(z[cb * 4 + rr * 2], z[cb * 4 + rr * 2 + 1]);
    LEM_PHASE(2);
    __syncthreads();  // this CTA's z' columns are in its own z rows
    send_own<HC>(z_s, rank, p);
    lem::cluster_arrive();
    if (STASH) {
#pragma unroll
      for (int cb = 0; cb < WN; ++cb)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::st_pair<true>(zs + s * NH + (size_t)grow[rr] * H + col(cb),
                             z[cb * 4 + rr * 2], z[cb * 4 + rr * 2 + 1],
                             ok[rr]);
    }
    LEM_PHASE(3);
    lem::cluster_wait();  // z' rows complete; every CTA done with y rows
    LEM_PHASE(4);

    float a[NE];
    product_wg<HC, HC>(a, z_s, desc_a, lr, t);
#pragma unroll
    for (int e = 0; e < NE; ++e) a[e] += pa[e];
    if (s + 1 < T) fetch_a(s + 1);
    LEM_PHASE(5);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      y[e] = (1.0f - dt2[e]) * y[e] + dt2[e] * lem::tanh_(a[e]);
#pragma unroll
    for (int cb = 0; cb < WN; ++cb)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(y_s + at(cb, rr)) =
            make_float2(y[cb * 4 + rr * 2], y[cb * 4 + rr * 2 + 1]);
    __syncthreads();  // this CTA's y' columns are in its own y rows
    send_own<HC>(y_s, rank, p);
    lem::cluster_arrive();
    if (STASH) {
#pragma unroll
      for (int cb = 0; cb < WN; ++cb)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::st_pair<true>(ys + s * NH + (size_t)grow[rr] * H + col(cb),
                             y[cb * 4 + rr * 2], y[cb * 4 + rr * 2 + 1],
                             ok[rr]);
    }
    LEM_PHASE(6);
    lem::cluster_wait();  // y' rows complete; every CTA done with z rows
    LEM_PHASE(7);
  }
#pragma unroll
  for (int cb = 0; cb < WN; ++cb)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t i = (size_t)grow[rr] * H + col(cb);
      lem::st_pair<false>(yT + i, y[cb * 4 + rr * 2], y[cb * 4 + rr * 2 + 1],
                          ok[rr]);
      lem::st_pair<false>(zT + i, z[cb * 4 + rr * 2], z[cb * 4 + rr * 2 + 1],
                          ok[rr]);
    }
}

unsigned long long g_smem_set[4];  // allow_smem, per variant

// the kernel for hidden H (96 or 128) with or without the stash; index its
// flag in g_smem_set
const void* variant(int H, bool stash, int* index) {
  *index = (H == 96 ? 2 : 0) + (stash ? 1 : 0);
  if (H == 96)
    return stash ? reinterpret_cast<const void*>(lem_fwd_kernel<24, true>)
                 : reinterpret_cast<const void*>(lem_fwd_kernel<24, false>);
  return stash ? reinterpret_cast<const void*>(lem_fwd_kernel<32, true>)
               : reinterpret_cast<const void*>(lem_fwd_kernel<32, false>);
}

}  // namespace

LEM_PHASE_READER(lem_fwd)

// Shared memory of a CTA at hidden H: the weights split in two, the y and
// z rows
extern "C" int lem_fwd_smem_bytes(int H) {
  return (8 * H * (H / C) + 2 * RT * H) * (int)sizeof(float);
}

// Clusters the card holds at once (0: none can be scheduled), or -(error)
extern "C" int lem_fwd_max_clusters(int H, int stash) {
  if (H != 96 && H != 128) return -(int)cudaErrorInvalidValue;
  int index;
  const void* kernel = variant(H, stash, &index);
  return lem::max_clusters(kernel, &g_smem_set[index], THREADS,
                           lem_fwd_smem_bytes(H));
}

// ys, zs: [T, N, H] stash outputs, or null for none. H is 96 or 128.
extern "C" int lem_fwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       float* yT, float* zT, float* ys, float* zs, int T,
                       int N, int H, float dt, void* stream) {
  if (H != 96 && H != 128) return (int)cudaErrorInvalidValue;
  const bool stash = ys != nullptr && zs != nullptr;
  int index;
  const void* kernel = variant(H, stash, &index);
  cudaError_t err = lem::allow_smem(kernel, &g_smem_set[index]);
  if (err != cudaSuccess) return (int)err;
  lem::ClusterLaunch l((N + RT - 1) / RT * C, THREADS, lem_fwd_smem_bytes(H),
                       (cudaStream_t)stream);
  if (H == 96) {
    err = stash ? cudaLaunchKernelEx(&l.cfg, lem_fwd_kernel<24, true>, gx, zx,
                                     y0, z0, wy, wzz, yT, zT, ys, zs, T, N, dt)
                : cudaLaunchKernelEx(&l.cfg, lem_fwd_kernel<24, false>, gx,
                                     zx, y0, z0, wy, wzz, yT, zT, ys, zs, T,
                                     N, dt);
  } else {
    err = stash ? cudaLaunchKernelEx(&l.cfg, lem_fwd_kernel<32, true>, gx, zx,
                                     y0, z0, wy, wzz, yT, zT, ys, zs, T, N, dt)
                : cudaLaunchKernelEx(&l.cfg, lem_fwd_kernel<32, false>, gx,
                                     zx, y0, z0, wy, wzz, yT, zT, ys, zs, T,
                                     N, dt);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
