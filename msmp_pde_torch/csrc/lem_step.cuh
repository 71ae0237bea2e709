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
#include <cuda.h>
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


// ---- the hidden-164 route (MSGMP-PDE) --------------------------------------
// The cluster layout above needs H/C to be a multiple of 8 and a CTA's
// quarter of the weights in shared memory; at H = 164 neither holds. Here a
// CTA owns GR = 16 rows (one m16 tile) and every hidden column, H padded to
// HP = 168 (21 n8 tiles) inside the kernel: padded columns and rows read as
// zeros, so the first 164 columns are those of the unpadded scan. Whole rows
// need no exchange between CTAs. The weights do not fit beside the rows, so
// they stream through a ring of shared-memory stages, each 24 k-rows of HP
// floats (16,128 bytes): 8 rows of Wy [H, 3H] with its three gate blocks
// side by side ([8][3][HP]), or 24 rows of Wzz, Wzz^T or Wy^T. A tile comes
// from one bulk tensor copy (TMA), whose box fills the padding with zeros,
// multicast to the C = 4 CTAs of a cluster: they own different rows and need
// the same tiles, so each tile leaves L2 once a cluster. The copies carry an
// evict-last L2 hint; the per-step inputs and outputs stream past them.
//
// Stage s is refilled by CTA s % C once every consumer warp of the cluster
// has released it (empty[s] of the issuing CTA counts C CW remote arrives);
// every CTA arms its own full[s] with the stage's bytes, so a copy that
// lands before the arming leaves the barrier's transaction count negative
// until then. All CTAs run every tile to the end, those without rows too,
// and leave through a cluster barrier, so no CTA exits while another can
// still write to it.
//
// The products run in 3xTF32 with mma.sync m16n8k8: CW = 7 consumer warps,
// warp w owning the n8 tiles 3w .. 3w + 2 of each gate and of a, so the
// gate arithmetic runs on the accumulators. A fragments come from row
// buffers of pitch RP = 172 floats and B fragments from the ring, whose
// k-row pitches (168 or 504 floats) put a fragment's 32 lanes on 32 banks.
// An eighth warp issues the copies.
namespace lem {
namespace gen {

constexpr int H = 164;
constexpr int GR = 16;                  // rows a CTA
constexpr int HP = 168;                 // H padded to 21 n8 tiles
constexpr int CW = 7;                   // consumer warps, 3 n8 tiles each
constexpr int THREADS = 32 * (CW + 1);  // and the producer warp
constexpr int RP = 172;                 // a row buffer's pitch, floats
constexpr int KROWS = 24;               // k-rows of HP floats a stage
constexpr int STAGE_FLOATS = KROWS * HP;
constexpr int STAGE_BYTES = 4 * STAGE_FLOATS;  // 16,128
constexpr int PHASE_BYTES = 128;        // the -DLEM_PHASE_TIMES counters

#ifdef LEM_PHASE_TIMES
// Thread 0 of CTA 0 adds each part's SM cycles to counters in shared memory
// (a global add at every tile would cost more than the tile) and adds them
// to lem::g_cycles at the end.
#define GEN_PHASE_START(cyc)                                  \
  unsigned long long* gen_cyc = (cyc);                        \
  if (threadIdx.x == 0)                                       \
    for (int i = 0; i < 16; ++i) gen_cyc[i] = 0;              \
  long long gen_t0 = clock64()
#define GEN_PHASE(n)                                          \
  do {                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                \
      const long long now = clock64();                        \
      gen_cyc[n] += now - gen_t0;                             \
      gen_t0 = now;                                           \
    }                                                         \
  } while (0)
// after a product on ring r: its time in r's waits as "ring wait" (1), the
// rest as "products" (2)
#define GEN_PHASE_RING(r)                                     \
  do {                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                \
      const long long now = clock64();                        \
      gen_cyc[1] += (r).waited;                               \
      gen_cyc[2] += now - gen_t0 - (r).waited;                \
      gen_t0 = now;                                           \
    }                                                         \
    (r).waited = 0;                                           \
  } while (0)
#define GEN_PHASE_END                                         \
  do {                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0)                  \
      for (int i = 0; i < 16; ++i) lem::g_cycles[i] += gen_cyc[i]; \
  } while (0)
#else
#define GEN_PHASE_START(cyc) \
  do {                       \
  } while (0)
#define GEN_PHASE(n) \
  do {               \
  } while (0)
#define GEN_PHASE_RING(r) \
  do {                    \
  } while (0)
#define GEN_PHASE_END \
  do {                \
  } while (0)
#endif

// ---- mbarriers and bulk tensor copies --------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Arrive on the barrier at `bar` of the cluster's CTA `rank`, with the
// default semantics (a release at CTA scope), as CUTLASS's multicast
// pipelines release a stage: a consumer's reads of the stage have returned
// once the mma that take them have issued. A release at cluster scope is a
// fence that also waits for the thread's outstanding global loads and
// stores (the next step's inputs, the stash); it made every launch about
// twice as long.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [r];\n}"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// The box of `map` at (c0, c1, c2) into shared address `dst` of every CTA
// of the cluster, completing on the barrier at `bar` of each
__device__ __forceinline__ void tma_multicast(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c0, int c1,
                                              int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster.L2::cache_hint [%0], [%1, {%4, %5, %6}], "
      "[%2], %3, %7;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "h"(static_cast<uint16_t>((1 << C) - 1)), "r"(c0), "r"(c1), "r"(c2),
         "l"(policy)
      : "memory");
}

// The producer (one thread a CTA): for each of `tiles` tiles in order, arm
// this CTA's full barrier of its stage once the stage's last use has
// landed, and, where this CTA issues the stage, copy the tile once every
// consumer of the cluster has released its last use. issue(i, dst, bar,
// policy) starts the copy of tile i.
template <int S, class Issue>
__device__ __forceinline__ void produce(uint32_t full0, uint32_t empty0,
                                        uint32_t stage0, int tiles, int rank,
                                        const Issue& issue) {
  const uint64_t policy = evict_last_policy();
  for (int i = 0; i < tiles; ++i) {
    const int s = i % S;
    const uint32_t u = i / S, full = full0 + 8 * s;
    if (u > 0) mbar_wait(full, (u - 1) & 1);
    mbar_expect(full, STAGE_BYTES);
    if (s % C == rank) {
      if (u > 0) mbar_wait(empty0 + 8 * s, (u - 1) & 1);
      issue(i, stage0 + s * STAGE_BYTES, full, policy);
    }
  }
}

// A consumer thread's place in the ring: the next tile to wait for, and
// the oldest tile not yet released (a warp holds at most two)
template <int S>
struct Ring {
  uint32_t full0, empty0;
  const float* stages;
  int ws = 0, rs = 0;
  uint32_t phase = 0;
#ifdef LEM_PHASE_TIMES
  long long waited = 0;  // SM cycles in wait()
#endif
  __device__ Ring(uint32_t f, uint32_t e, const float* st)
      : full0(f), empty0(e), stages(st) {}
  // the next tile, once it has landed
  __device__ __forceinline__ const float* wait() {
#ifdef LEM_PHASE_TIMES
    const long long t0 = clock64();
    mbar_wait(full0 + 8 * ws, phase);
    waited += clock64() - t0;
#else
    mbar_wait(full0 + 8 * ws, phase);
#endif
    const float* st = stages + ws * STAGE_FLOATS;
    if (++ws == S) {
      ws = 0;
      phase ^= 1;
    }
    return st;
  }
  // this warp is done with the oldest tile it holds
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive_at(empty0 + 8 * rs, rs % C);
    if (++rs == S) rs = 0;
  }
};

// The stage and row buffers and the barriers of a kernel with S stages and
// ROWF floats of row buffers: its shared memory in bytes
__host__ __device__ constexpr int smem_bytes(int S, int ROWF) {
  return S * STAGE_BYTES + 4 * ROWF + 16 * S + PHASE_BYTES;
}

// A thread's operands of one tile, as loaded: for each of KS k-steps its A
// fragment (rows g, g + 8; columns k, k + 4) and the B fragments of its
// three n8 tiles of each of NQ gate blocks
template <int KS, int NQ>
struct Frags {
  float a[KS][4];
  float b[KS][NQ][3][2];
};

// k-step ks of a tile reads the A columns a0 + ks astep + [0, 8) and the
// stage's k-rows 8 ks + [0, 8) (pitch KP), gate block q at column q HP.
// ra, rb: the thread's rows g and g + 8 of the A buffer; n0 = 24 warp + g.
template <int KS, int NQ, int KP>
__device__ __forceinline__ void load_frags(Frags<KS, NQ>& f, const float* ra,
                                           const float* rb, int a0,
                                           int astep, const float* stage,
                                           int n0, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = a0 + ks * astep + t;
    f.a[ks][0] = ra[k];
    f.a[ks][1] = rb[k];
    f.a[ks][2] = ra[k + 4];
    f.a[ks][3] = rb[k + 4];
    const float* b = stage + (8 * ks + t) * KP + n0;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        f.b[ks][q][j][0] = b[q * HP + 8 * j];
        f.b[ks][q][j][1] = b[4 * KP + q * HP + 8 * j];
      }
  }
}

// acc[q][j] += A B over one tile's k-steps, in 3xTF32; the three passes in
// turn, so that consecutive mma write different accumulators
template <int KS, int NQ>
__device__ __forceinline__ void mma_frags(float (&acc)[NQ][3][4],
                                          const Frags<KS, NQ>& f) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ab[4], as[4], bb[NQ][3][2], bs[NQ][3][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(f.a[ks][e], ab[e], as[e]);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(f.b[ks][q][j][h], bb[q][j][h], bs[q][j][h]);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j) mma_tf32(acc[q][j], as, bb[q][j]);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j) mma_tf32(acc[q][j], ab, bs[q][j]);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j) mma_tf32(acc[q][j], ab, bb[q][j]);
  }
}

// acc += the 16 rows of an A buffer times the next `tiles` tiles of the
// ring, tile i's A columns starting at a0 + i astride. Software-pipelined:
// tile i + 1's operands load while tile i's mma run, and tile i is released
// after them. ra, rb, astep, n0, t: as load_frags.
template <int KS, int NQ, int KP, int S>
__device__ __forceinline__ void product(float (&acc)[NQ][3][4], Ring<S>& ring,
                                        int tiles, const float* ra,
                                        const float* rb, int a0, int astride,
                                        int astep, int n0, int t, int lane) {
  Frags<KS, NQ> f0, f1;
  load_frags<KS, NQ, KP>(f0, ra, rb, a0, astep, ring.wait(), n0, t);
  int i = 0;
  for (; i + 2 <= tiles; i += 2) {
    load_frags<KS, NQ, KP>(f1, ra, rb, a0 + (i + 1) * astride, astep,
                           ring.wait(), n0, t);
    mma_frags(acc, f0);
    ring.release(lane);
    if (i + 2 < tiles)
      load_frags<KS, NQ, KP>(f0, ra, rb, a0 + (i + 2) * astride, astep,
                             ring.wait(), n0, t);
    mma_frags(acc, f1);
    ring.release(lane);
  }
  if (i < tiles) {
    mma_frags(acc, f0);
    ring.release(lane);
  }
}

// The consumer warps' barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CW * 32) : "memory");
}

// A consumer thread: lane (g, t) of warp w holds, of n8 tile j, the
// elements e of rows g + 8 (e >> 1) and hidden columns col[j] + (e & 1)
struct Lane {
  int warp, lane, g, t, n0;
  int col[3];
  bool cok[3];
  __device__ Lane() {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    n0 = 24 * warp + g;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      col[j] = 24 * warp + 8 * j + 2 * t;
      cok[j] = col[j] < H;  // even, so col + 1 < H too
    }
  }
};

// Rows [row0, row0 + GR) of x [N, H] into a row buffer with cp.async (wait
// with cp_async_wait_all); rows past N read as zeros. The consumer threads.
__device__ inline void load_rows(float* buf, const float* __restrict__ x,
                                 int row0, int N) {
  constexpr int PER_ROW = H / 4;
  for (int i = threadIdx.x; i < GR * PER_ROW; i += CW * 32) {
    const int r = i / PER_ROW, k = (i % PER_ROW) * 4;
    const bool ok = row0 + r < N;
    cp_async16(smem_addr(buf + r * RP + k),
               x + (size_t)(ok ? row0 + r : 0) * H + k, ok);
  }
}

// ---- tensor maps (host) ---------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A float32 tensor of dims d (d[0] contiguous; byte strides s1, s2 of d[1],
// d[2]) read in boxes b, past its end as zeros. Needs a 16-byte aligned
// base and strides.
inline cudaError_t encode_map(CUtensorMap* map, const float* base,
                              const cuuint64_t (&d)[3], cuuint64_t s1,
                              cuuint64_t s2, const cuuint32_t (&b)[3]) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), d,
      strides, b, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Wy [H, 3H] in tiles of 8 rows by its three gate blocks: [8][3][HP]
inline cudaError_t map_wy(CUtensorMap* map, const float* wy) {
  return encode_map(map, wy, {H, 3, H}, 4 * H, 12 * H, {HP, 3, 8});
}

// W [H, H] (Wzz, Wzz^T) in tiles of KROWS rows: [KROWS][HP]
inline cudaError_t map_square(CUtensorMap* map, const float* w) {
  return encode_map(map, w, {H, H, 1}, 4 * H, 4 * H * H, {HP, KROWS, 1});
}

// Wy^T [3H, H] in tiles of 8 rows of each gate block: [3][8][HP]
inline cudaError_t map_wyT(CUtensorMap* map, const float* wyT) {
  return encode_map(map, wyT, {H, H, 3}, 4 * H, 4 * H * H, {HP, 8, 3});
}

}  // namespace gen

// The route of each hidden width: the clusters at 96 and 128, the hidden-164
// route at 164 (MSGMP-PDE's); no other width is taken.
inline bool cluster_width(int H) { return H == 96 || H == 128; }
inline bool ring_width(int H) { return H == gen::H; }

}  // namespace lem
