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
//
// At hidden 164 (MSGMP-PDE) the cluster layout does not fit (lem_step.cuh,
// the hidden-164 route): lem_fwd_ring runs clusters of 4 CTAs, each CTA
// over 16 rows and every column (164 padded to 168), with Wy and Wzz
// streamed through a ring of shared-memory stages by bulk tensor copies
// multicast to the cluster's 4 CTAs, and the products in 3xTF32 on
// mma.sync. At N = 1600 that is 100 CTAs, one wave, and each step's 430 KB
// of weights leave L2 once a cluster (~270 MB a launch, not ~1.1 GB). What
// bounds it: operations, 8.6 GFLOP of products at N = 1600, T = 25, against
// 105 MB of gx and zx reads; mma.sync's TF32 issue rate at 16 rows a CTA
// (tools/lem_phases.py --hidden 164 splits a launch).
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

// The hidden-164 route (lem_step.cuh, lem::gen): CTA b owns rows
// [b GR, (b + 1) GR) and every hidden column; its consumer warps hold y and z
// of their columns in registers, and the y and z rows in row buffers for the
// products. A step streams 21 tiles of Wy (g = gx_t + y Wy), then z' into the
// z rows and a barrier of the consumer warps, then 7 tiles of Wzz
// (a = zx_t + z' Wzz), y' into the y rows and a barrier. Each buffer is
// written between the two barriers that follow its last read. The padded
// columns stay exactly zero: their inputs, weights and states are.
namespace gen = lem::gen;
constexpr int GEN_STAGES = 12;             // ring stages
constexpr int GEN_TILES = 21 + 7;          // tiles a step: Wy, then Wzz
constexpr int GEN_ROWF = 2 * gen::GR * gen::RP;  // y, z rows

template <bool STASH>
__global__ void __launch_bounds__(gen::THREADS, 1)
lem_fwd_ring(const __grid_constant__ CUtensorMap map_wy,
             const __grid_constant__ CUtensorMap map_wzz,
             const float* __restrict__ gx, const float* __restrict__ zx,
             const float* __restrict__ y0, const float* __restrict__ z0,
             float* __restrict__ yT, float* __restrict__ zT,
             float* __restrict__ ys, float* __restrict__ zs, int T, int N,
             float dt) {
  constexpr int H = gen::H, GR = gen::GR, HP = gen::HP, RP = gen::RP;
  constexpr int CW = gen::CW, KROWS = gen::KROWS, THREADS = gen::THREADS;
  constexpr int S = GEN_STAGES;
  extern __shared__ __align__(1024) float4 gen_smem[];
  float* ring = reinterpret_cast<float*>(gen_smem);
  float* y_s = ring + S * gen::STAGE_FLOATS;  // [GR][RP]
  float* z_s = y_s + GR * RP;            // [GR][RP]
  uint64_t* bars = reinterpret_cast<uint64_t*>(z_s + GR * RP);  // full, empty
  GEN_PHASE_START(reinterpret_cast<unsigned long long*>(bars + 2 * S));
  const int rank = static_cast<int>(lem::cluster_rank());
  const uint32_t full0 = lem::smem_addr(bars), empty0 = full0 + 8 * S;
  for (int i = threadIdx.x; i < GEN_ROWF; i += THREADS) y_s[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      gen::mbar_init(full0 + 8 * s, 1);
      gen::mbar_init(empty0 + 8 * s, lem::C * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  lem::cluster_sync();  // every CTA's barriers are set up

  if (threadIdx.x >= CW * 32) {  // the producer warp
    const CUtensorMap* m_wy = &map_wy;
    const CUtensorMap* m_wzz = &map_wzz;
    if (threadIdx.x == CW * 32)
      gen::produce<S>(full0, empty0, lem::smem_addr(ring), T * GEN_TILES, rank,
                 [&](int i, uint32_t dst, uint32_t bar, uint64_t policy) {
                   const int k = i % GEN_TILES;
                   if (k < 21)
                     gen::tma_multicast(dst, m_wy, bar, 0, 0, 8 * k, policy);
                   else
                     gen::tma_multicast(dst, m_wzz, bar, 0, KROWS * (k - 21),
                                   0, policy);
                 });
    __syncwarp();
  } else {
    const gen::Lane l;
    gen::Ring<S> ring_(full0, empty0, ring);
    const int row0 = blockIdx.x * GR;
    int row[2];
    bool rok[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      row[rr] = row0 + l.g + 8 * rr;
      rok[rr] = row[rr] < N;
    }
    auto ok = [&](int j, int rr) { return l.cok[j] && rok[rr]; };
    // this thread's element (j, rr) of x [*, ld] at row offset base
    auto at = [&](auto* x, size_t base, int ld, int j, int rr) {
      return x + (base + row[rr]) * ld + l.col[j];
    };
    float y[3][4], z[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lem::ld_pair(y[j] + 2 * rr, at(y0, 0, H, j, rr), ok(j, rr));
        lem::ld_pair(z[j] + 2 * rr, at(z0, 0, H, j, rr), ok(j, rr));
      }
    // this thread's elements (j, rr) in a row buffer: a float2
    auto put = [&](float* buf, const float (&v)[3][4]) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(buf + (l.g + 8 * rr) * RP + l.col[j]) =
              make_float2(v[j][2 * rr], v[j][2 * rr + 1]);
    };
    auto stash = [&](float* x, size_t step, const float (&v)[3][4]) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::st_pair<true>(at(x, step * N, H, j, rr), v[j][2 * rr],
                             v[j][2 * rr + 1], ok(j, rr));
    };
    float pg[3][3][4], pa[1][3][4];  // gx_t, zx_t of this thread's elements
    auto fetch_g = [&](int s) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            lem::ld_pair(pg[q][j] + 2 * rr,
                         at(gx, (size_t)s * N, 3 * H, j, rr) + q * H,
                         ok(j, rr));
    };
    auto fetch_a = [&](int s) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::ld_pair(pa[0][j] + 2 * rr, at(zx, (size_t)s * N, H, j, rr),
                       ok(j, rr));
    };
    put(y_s, y);
    if (T > 0) {
      fetch_g(0);
      fetch_a(0);
    }
    const float* ya = y_s + l.g * RP;
    const float* za = z_s + l.g * RP;
    gen::consumers_sync();  // the y rows are in
    GEN_PHASE(0);
    for (int s = 0; s < T; ++s) {
      float g[3][3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[q][j][e] = pg[q][j][e];
      if (s + 1 < T) fetch_g(s + 1);
      gen::product<1, 3, 3 * HP>(g, ring_, 21, ya, ya + 8 * RP, 0, 8, 0, l.n0,
                                 l.t, l.lane);
      GEN_PHASE_RING(ring_);
      float dt2[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dt1 = dt * lem::sigm(g[0][j][e]);
          z[j][e] = (1.0f - dt1) * z[j][e] + dt1 * lem::tanh_(g[2][j][e]);
          dt2[j][e] = dt * lem::sigm(g[1][j][e]);
        }
      GEN_PHASE(3);
      put(z_s, z);
      if (STASH) stash(zs, s, z);
      GEN_PHASE(4);
      gen::consumers_sync();  // the z' rows are complete
      GEN_PHASE(5);

      float a[1][3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[0][j][e] = pa[0][j][e];
      if (s + 1 < T) fetch_a(s + 1);
      gen::product<3, 1, HP>(a, ring_, 7, za, za + 8 * RP, 0, KROWS, 8, l.n0,
                             l.t, l.lane);
      GEN_PHASE_RING(ring_);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[j][e] = (1.0f - dt2[j][e]) * y[j][e] +
                    dt2[j][e] * lem::tanh_(a[0][j][e]);
      GEN_PHASE(3);
      put(y_s, y);
      if (STASH) stash(ys, s, y);
      GEN_PHASE(4);
      gen::consumers_sync();  // the y' rows are complete
      GEN_PHASE(5);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lem::st_pair<false>(at(yT, 0, H, j, rr), y[j][2 * rr],
                            y[j][2 * rr + 1], ok(j, rr));
        lem::st_pair<false>(at(zT, 0, H, j, rr), z[j][2 * rr],
                            z[j][2 * rr + 1], ok(j, rr));
      }
  }
  GEN_PHASE_END;
  lem::cluster_sync();  // no CTA leaves while the others may still signal it
}

unsigned long long g_smem_set[4];  // allow_smem, per variant
unsigned long long g_ring_set[2];  // allow_smem, the hidden-164 route

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

const void* ring_variant(bool stash) {
  return stash ? reinterpret_cast<const void*>(lem_fwd_ring<true>)
               : reinterpret_cast<const void*>(lem_fwd_ring<false>);
}

}  // namespace

LEM_PHASE_READER(lem_fwd)

// Shared memory of a CTA at hidden H: the weights split in two, the y and
// z rows; at 164 the ring, the y and z rows and the barriers
extern "C" int lem_fwd_smem_bytes(int H) {
  if (lem::ring_width(H))
    return lem::gen::smem_bytes(GEN_STAGES, GEN_ROWF);
  return (8 * H * (H / C) + 2 * RT * H) * (int)sizeof(float);
}

// Rows a CTA holds at hidden H: at 164 its own GR, at 96 and 128 its
// cluster's RT (each CTA a slice of the columns)
extern "C" int lem_fwd_cta_rows(int H) {
  return lem::ring_width(H) ? lem::gen::GR : RT;
}

// Clusters the card holds at once (0: none can be scheduled), or -(error)
extern "C" int lem_fwd_max_clusters(int H, int stash) {
  if (lem::ring_width(H))
    return lem::max_clusters(ring_variant(stash), &g_ring_set[stash ? 1 : 0],
                             lem::gen::THREADS, lem_fwd_smem_bytes(H));
  if (!lem::cluster_width(H)) return -(int)cudaErrorInvalidValue;
  int index;
  const void* kernel = variant(H, stash, &index);
  return lem::max_clusters(kernel, &g_smem_set[index], THREADS,
                           lem_fwd_smem_bytes(H));
}

// ys, zs: [T, N, H] stash outputs, or null for none. H is 96 or 128 (the
// clusters) or 164 (the hidden-164 route; wy and wzz 16-byte aligned).
extern "C" int lem_fwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       float* yT, float* zT, float* ys, float* zs, int T,
                       int N, int H, float dt, void* stream) {
  const bool stash = ys != nullptr && zs != nullptr;
  if (lem::ring_width(H)) {
    cudaError_t err =
        lem::allow_smem(ring_variant(stash), &g_ring_set[stash ? 1 : 0]);
    CUtensorMap map_wy, map_wzz;
    if (err == cudaSuccess) err = lem::gen::map_wy(&map_wy, wy);
    if (err == cudaSuccess) err = lem::gen::map_square(&map_wzz, wzz);
    if (err != cudaSuccess) return (int)err;
    lem::ClusterLaunch l((N + C * lem::gen::GR - 1) / (C * lem::gen::GR) * C,
                         lem::gen::THREADS, lem_fwd_smem_bytes(H),
                         (cudaStream_t)stream);
    err = stash ? cudaLaunchKernelEx(&l.cfg, lem_fwd_ring<true>, map_wy,
                                     map_wzz, gx, zx, y0, z0, yT, zT, ys, zs,
                                     T, N, dt)
                : cudaLaunchKernelEx(&l.cfg, lem_fwd_ring<false>, map_wy,
                                     map_wzz, gx, zx, y0, z0, yT, zT, ys, zs,
                                     T, N, dt);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (!lem::cluster_width(H)) return (int)cudaErrorInvalidValue;
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
