// LEM recurrent scan, backward (BPTT reverse sweep), float32.
//
// Replaces: msmp_pde_tpu/ops/lem_pallas.py::_bwd_kernel, driven there by
// make_lem_scan._run_bwd.
//
// For every row independently, t = T-1 .. 0, from the forward's stash
// (ys[t] = y_{t+1}, zs[t] = z_{t+1}; y_prev = y0 at t = 0, else ys[t-1]):
//   recompute g = gx_t + y_prev Wy (s1, s2, tanh(zc)), a = zx_t + z_t Wzz
//   da  = dy dt2 (1 - tanh(a)^2),  dg2 = dy (tanh(a) - y_prev) dt s2 (1 - s2)
//   dz += da Wzz^T
//   dg1 = dz (tanh(zc) - z_prev) dt s1 (1-s1),  dzc = dz dt1 (1 - tanh(zc)^2)
//   dy  = dy (1 - dt2) + [dg1 dg2 dzc] Wy^T,    dz  = dz (1 - dt1)
// and writes dgx_t = [dg1 dg2 dzc], dzx_t = da; (dy, dz) at the end are
// dy0, dz0. The weight gradients are dWy = sum_t y_prev^T dgx_t and
// dWzz = sum_t z_t^T dzx_t.
//
// What bounds it on an H100: operations, and the recurrence. At N = 1600,
// T = 25, H = 128 the sweep's four recurrent products (recompute g and a,
// dz and dy) are 10.5 GFLOP and the two weight gradients 5.2 GFLOP of
// float32, against ~164 MB of reads and writes; each step needs the whole
// step after it of its rows. The products take ~80% of a launch
// (tools/lem_phases.py): mma.sync issues a TF32 m16n8k8 only every ~12-18
// cycles on an SM's quarter, three of them for each float32 product.
//
// Design: the forward's cluster (lem_step.cuh), C = 4 CTAs over RT = 64
// rows, CTA i owning the hidden columns J_i and keeping those columns of Wy
// and Wzz resident, with the forward's gate functions. The recompute runs
// mma.sync on the raw weights: the forward's wgmma wants them split in two
// copies (128 KB at H = 128), which do not fit beside this kernel's buffers.
// So the recompute's products and gate arithmetic are this file's own, a
// second copy of the step beside lem_fwd.cu's; the weight gather
// (lem::load_weights, with this kernel's fragment layout) and the gate
// functions are lem_step.cuh's.
// The two transposed products need whole rows of da and dg, which are
// spread over the cluster. Each CTA therefore forms the full-width partial
// product of its own columns with the weights it already holds
// (da_i Wzz[:, J_i]^T, dg_i Wy[:, cols_i]^T; option (ii) of the design: no
// second copy of the weights, which would not fit either) and writes each
// CTA's quarter of it into that CTA's shared memory; after a cluster
// barrier a CTA sums the four partials of its columns in rank order, so
// the result is bitwise the same from run to run. A step has two such
// exchanges and two cluster barriers.
//
// The weight gradients are accumulated inside the sweep, as the TPU kernel
// does: CTA i owns dWy[:, cols_i] and dWzz[:, J_i] in registers (two 16 x 8
// tiles of each of its four gates a warp, 3xTF32) and adds each step's
// y_prev^T dg and z_t^T da from the row buffers it already holds, so dgx,
// dzx and the stash are not read a second time. Each cluster writes its
// [H, 4H] partial once, and lem_bwd_reduce sums the clusters' partials in
// cluster order. No float atomics: bitwise repeatable. That takes 16 warps
// for the 16384 sums at H = 128; at N = 1600 the 25 clusters are one wave
// of 100 CTAs.
//
// Shared memory (198,656 bytes at H = 128): the weights; the y_prev and z_t
// rows (cp.async: the next step's y rows load while the cluster gathers the
// dy partials, the z rows, which receive those partials, after); the dz
// partials that the other CTAs write; da and dg of the CTA's columns.
//
// At hidden 164 (MSGMP-PDE) the cluster layout does not fit (lem_step.cuh,
// the hidden-164 route): lem_transpose writes Wy^T and Wzz^T once;
// lem_bwd_ring runs the sweep on clusters of 4 CTAs, each over 16 rows and
// every column (164 padded to 168), with Wy, Wzz and the transposes
// streamed through a ring of shared-memory stages by bulk tensor copies
// multicast to the cluster, four products a step in 3xTF32 on mma.sync;
// it writes dgx, dzx, dy0, dz0. lem_bwd_wgrad then forms dWy = sum y_prev^T
// dgx and dWzz = sum z_t^T dzx over the T N rows on the tensor cores
// (3xTF32), the rows split in WSPLIT parts, and lem_bwd_reduce sums the
// parts in order. No atomics: bitwise repeatable. What bounds it:
// operations, 17.2 GFLOP in the sweep and 8.6 in the weight gradients at
// N = 1600, T = 25, against ~260 MB of reads and writes; mma.sync's TF32
// issue rate (tools/lem_phases.py --hidden 164).
#include "lem_step.cuh"

namespace {

using lem::C;
using lem::RT;

// threads of a CTA: the cluster's RT rows by its H/C columns, 16 x 8 a warp
constexpr int threads(int H) { return 32 * (RT / 16) * (H / C / 8); }

__device__ __forceinline__ void put2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Where lem::load_weights puts the CTA's columns of Wy (J_i of each gate)
// and of Wzz: as mma.sync B fragments, raw. Tile nt = wn*4 + q (q: g1, g2,
// zc, a), k-step ks, lane (g, t) holds (W[8ks + t][n], W[8ks + t + 4][n])
// of its column n = g of the tile.
struct StoreFrag {
  float* wf;
  int KS;
  __device__ void operator()(int k, int q, int c, float w) const {
    const int nt = (c >> 3) * 4 + q, kk = k & 7;
    const int lane = 4 * (c & 7) + (kk & 3);
    wf[((nt * KS + (k >> 3)) * 32 + lane) * 2 + (kk >> 2)] = w;
  }
};

// acc[q] += rows[16 rows of the warp, :] @ W tile (nt0 + q), for q < NQ,
// over k in [0, H), in 3xTF32: the recompute's y_prev Wy (tiles
// wn*4 + 0..2) and z_t Wzz (tile wn*4 + 3).
template <int NQ>
__device__ __forceinline__ void product(float (&acc)[NQ][4],
                                        const float* rows, const float* wf,
                                        int nt0, const lem::Tile& p) {
  const float* ra = rows + (p.wm * 16 + p.g) * p.H;
  const float* rb = ra + 8 * p.H;
  const int sw = p.g << 2;
#pragma unroll 4
  for (int ks = 0; ks < p.KS; ++ks) {
    const int k = 8 * ks + p.t;
    uint32_t ab[4], as[4];
    lem::split_tf32(ra[k ^ sw], ab[0], as[0]);
    lem::split_tf32(rb[k ^ sw], ab[1], as[1]);
    lem::split_tf32(ra[(k + 4) ^ sw], ab[2], as[2]);
    lem::split_tf32(rb[(k + 4) ^ sw], ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float2 b = reinterpret_cast<const float2*>(
          wf)[((nt0 + q) * p.KS + ks) * 32 + p.lane];
      uint32_t bb[2], bs[2];
      lem::split_tf32(b.x, bb[0], bs[0]);
      lem::split_tf32(b.y, bb[1], bs[1]);
      lem::mma_tf32(acc[q], as, bb);
      lem::mma_tf32(acc[q], ab, bs);
      lem::mma_tf32(acc[q], ab, bb);
    }
  }
}

// acc[k] += buf[16 rows of the warp, 0 : 8 NQ WN) @ W^T for output tile
// nj = k WN + wn (hidden rows 8 nj + [0, 8) of W), k < C: the transposed
// products da Wzz[:, J_i]^T (Q0 = 3, NQ = 1) and dg Wy[:, cols_i]^T (Q0 =
// 0, NQ = 3). buf's column q' HC + c holds gate Q0 + q', local column c, so
// its k-block kb reads weight tile (kb % WN) * 4 + Q0 + kb / WN, whose
// fragments are read transposed: lane (g, t) takes W[8 nj + g][8 kb' + t]
// and W[8 nj + g][8 kb' + t + 4] from the lanes that hold them.
template <int Q0, int NQ>
__device__ __forceinline__ void product_t(float (&acc)[C][4], const float* buf,
                                          int pitch, const float* wf,
                                          const lem::Tile& p) {
  const float* ra = buf + (p.wm * 16 + p.g) * pitch;
  const float* rb = ra + 8 * pitch;
  const int l0 = 2 * (4 * p.t + (p.g & 3)) + (p.g >> 2), l1 = l0 + 32;
#pragma unroll 2
  for (int kb = 0; kb < NQ * p.WN; ++kb) {
    const int k = 8 * kb + p.t;
    uint32_t ab[4], as[4];
    lem::split_tf32(ra[k], ab[0], as[0]);
    lem::split_tf32(rb[k], ab[1], as[1]);
    lem::split_tf32(ra[k + 4], ab[2], as[2]);
    lem::split_tf32(rb[k + 4], ab[3], as[3]);
    const int nt = (kb % p.WN) * 4 + Q0 + kb / p.WN;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* w = wf + (nt * p.KS + c * p.WN + p.wn) * 64;
      uint32_t bb[2], bs[2];
      lem::split_tf32(w[l0], bb[0], bs[0]);
      lem::split_tf32(w[l1], bb[1], bs[1]);
      lem::mma_tf32(acc[c], as, bb);
      lem::mma_tf32(acc[c], ab, bs);
      lem::mma_tf32(acc[c], ab, bb);
    }
  }
}

// dw[q][u] += rows^T buf over the RT rows, for q in [Q0, Q0 + NQ): the
// warp's tiles u (tile = warp + u nwarps of the (H/16) x WN tiles of a
// gate: hidden rows mj*16 + [0, 16) of the gradient, the CTA's local
// columns nc*8 + [0, 8)); rows is a swizzled [RT, H] row buffer (y_prev for
// dWy, z_t for dWzz), buf the [RT, pitch] da or dg, gate Q0 + q' at column
// q' HC.
template <int Q0, int NQ>
__device__ __forceinline__ void grad_w(float (&dw)[4][2][4], const float* rows,
                                       const float* buf, int pitch, int nwarps,
                                       const lem::Tile& p) {
  const int tiles = (p.H / 16) * p.WN;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tile = p.warp + u * nwarps;
    if (tile >= tiles) break;
    const int j = (tile / p.WN) * 16 + p.g, cb = (tile % p.WN) * 8 + p.g;
    for (int kr = 0; kr < RT / 8; ++kr) {
      const int r = 8 * kr + p.t;
      uint32_t ab[4], as[4];
      lem::split_tf32(rows[p.at(r, j)], ab[0], as[0]);
      lem::split_tf32(rows[p.at(r, j + 8)], ab[1], as[1]);
      lem::split_tf32(rows[p.at(r + 4, j)], ab[2], as[2]);
      lem::split_tf32(rows[p.at(r + 4, j + 8)], ab[3], as[3]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float* b = buf + q * p.HC + cb;
        uint32_t bb[2], bs[2];
        lem::split_tf32(b[r * pitch], bb[0], bs[0]);
        lem::split_tf32(b[(r + 4) * pitch], bb[1], bs[1]);
        lem::mma_tf32(dw[Q0 + q][u], as, bb);
        lem::mma_tf32(dw[Q0 + q][u], ab, bs);
        lem::mma_tf32(dw[Q0 + q][u], ab, bb);
      }
    }
  }
}

__global__ void __launch_bounds__(512, 1)
lem_bwd_sweep(const float* __restrict__ gx, const float* __restrict__ zx,
              const float* __restrict__ y0, const float* __restrict__ z0,
              const float* __restrict__ wy, const float* __restrict__ wzz,
              const float* __restrict__ ys, const float* __restrict__ zs,
              const float* __restrict__ dyT, const float* __restrict__ dzT,
              float* __restrict__ dgx, float* __restrict__ dzx,
              float* __restrict__ dy0, float* __restrict__ dz0,
              float* __restrict__ partial, int T, int N, int H, float dt) {
  extern __shared__ float4 smem4[];
  LEM_PHASE_START;
  const lem::Tile p(H);
  const int HC = p.HC, RH = RT * H, DAP = HC + 4, DGP = 3 * HC + 4;
  const int nwarps = blockDim.x >> 5;
  float* wf = reinterpret_cast<float*>(smem4);  // the weights
  float* yr = wf + 4 * H * HC;                  // y_prev rows, swizzled
  float* zr = yr + RH;                          // z_t rows; then dy partials
  float* rz = zr + RH;                          // dz partials
  float* da_s = rz + RH;                        // [RT, DAP]
  float* dg_s = da_s + RT * DAP;                // [RT, DGP]: g1 | g2 | zc
  const int cluster = blockIdx.x / C, row0 = cluster * RT;
  const size_t H3 = 3 * (size_t)H, NH = (size_t)N * H;

  lem::load_weights(wy, wzz, H, p.rank, blockDim.x, StoreFrag{wf, p.KS});
  const int ra = row0 + p.lr, rb = ra + 8;
  const bool oka = ra < N, okb = rb < N;
  const size_t ia = (size_t)ra * H + p.col, ib = (size_t)rb * H + p.col;
  float dy[4], dz[4];
  lem::ld_pair(dy, dyT + ia, oka);
  lem::ld_pair(dy + 2, dyT + ib, okb);
  lem::ld_pair(dz, dzT + ia, oka);
  lem::ld_pair(dz + 2, dzT + ib, okb);
  float pg[3][4], pa[4], pz[4];  // gx_t, zx_t, z_prev of its elements
  auto fetch = [&](int t) {
    const float* gt = gx + t * N * H3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lem::ld_pair(pg[q], gt + ra * H3 + q * H + p.col, oka);
      lem::ld_pair(pg[q] + 2, gt + rb * H3 + q * H + p.col, okb);
    }
    lem::ld_pair(pa, zx + t * NH + ia, oka);
    lem::ld_pair(pa + 2, zx + t * NH + ib, okb);
    const float* zp = t ? zs + (t - 1) * NH : z0;
    lem::ld_pair(pz, zp + ia, oka);
    lem::ld_pair(pz + 2, zp + ib, okb);
  };
  auto y_prev = [&](int t) { return t ? ys + (t - 1) * NH : y0; };
  if (T > 0) {
    fetch(T - 1);
    lem::load_rows(yr, y_prev(T - 1), row0, N, p);
    lem::load_rows(zr, zs + (T - 1) * NH, row0, N, p);
  }
  float dw[4][2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[q][u][e] = 0.0f;
  __syncthreads();
  lem::cluster_sync();  // every CTA has started
  LEM_PHASE(0);

  // this thread's elements: (lr, col), (lr + 8, col) of a row buffer; its
  // local column in da_s / dg_s; its float4 slot of a partial from rank s
  const int oa = p.at(p.lr, p.col), ob = oa + 8 * H;
  const int lc = p.wn * 8 + 2 * p.t;
  const int slot = (p.rank * nwarps + p.warp) * 32 + p.lane;
  const uint32_t rz_a = lem::smem_addr(rz) + 16 * slot;
  const uint32_t zr_a = lem::smem_addr(zr) + 16 * slot;
  for (int t = T - 1; t >= 0; --t) {
    lem::cp_async_wait_all();
    __syncthreads();  // this step's y_prev and z_t rows are in
    float g[3][4], a[1][4], zp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[0][e] = pg[0][e];
      g[1][e] = pg[1][e];
      g[2][e] = pg[2][e];
      a[0][e] = pa[e];
      zp[e] = pz[e];
    }
    if (t > 0) fetch(t - 1);

    LEM_PHASE(1);
    // recompute the step, as the forward computes it
    product<3>(g, yr, wf, p.wn * 4, p);
    product<1>(a, zr, wf, p.wn * 4 + 3, p);
    LEM_PHASE(2);
    float s1[4], thz[4], dt2[4], da[4], dg2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1[e] = lem::sigm(g[0][e]);
      const float s2 = lem::sigm(g[1][e]);
      thz[e] = lem::tanh_(g[2][e]);
      const float tha = lem::tanh_(a[0][e]);
      const float yp = yr[(e & 2 ? ob : oa) + (e & 1)];
      dt2[e] = dt * s2;
      da[e] = dy[e] * dt2[e] * (1.0f - tha * tha);
      dg2[e] = dy[e] * (tha - yp) * dt * s2 * (1.0f - s2);
    }
    float* dzxt = dzx + t * NH;
    float* dgxt = dgx + t * N * H3;
    lem::st_pair<true>(dzxt + ia, da[0], da[1], oka);
    lem::st_pair<true>(dzxt + ib, da[2], da[3], okb);
    lem::st_pair<true>(dgxt + ra * H3 + H + p.col, dg2[0], dg2[1], oka);
    lem::st_pair<true>(dgxt + rb * H3 + H + p.col, dg2[2], dg2[3], okb);
    put2(da_s + p.lr * DAP + lc, da[0], da[1]);
    put2(da_s + (p.lr + 8) * DAP + lc, da[2], da[3]);
    put2(dg_s + p.lr * DGP + HC + lc, dg2[0], dg2[1]);
    put2(dg_s + (p.lr + 8) * DGP + HC + lc, dg2[2], dg2[3]);
    __syncthreads();  // da of the CTA's columns complete
    LEM_PHASE(3);

    // dz += da Wzz^T: each CTA's quarter of this CTA's partial to that CTA
    {
      float part[C][4] = {};
      product_t<3, 1>(part, da_s, DAP, wf, p);
#pragma unroll
      for (int k = 0; k < C; ++k)
        lem::st_cluster(lem::remote(rz_a, k), part[k]);
    }
    LEM_PHASE(4);
    grad_w<3, 1>(dw, zr, da_s, DAP, nwarps, p);
    LEM_PHASE(5);
    lem::cluster_sync();  // dz partials in; every CTA done with its z rows
    LEM_PHASE(6);

    const float4* rz4 = reinterpret_cast<const float4*>(rz);
    float sum[4] = {};
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float4 v = rz4[(s * nwarps + p.warp) * 32 + p.lane];
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    float dg1[4], dzc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dz[e] += sum[e];
      const float dt1 = dt * s1[e];
      dg1[e] = dz[e] * (thz[e] - zp[e]) * dt * s1[e] * (1.0f - s1[e]);
      dzc[e] = dz[e] * dt1 * (1.0f - thz[e] * thz[e]);
      dz[e] *= 1.0f - dt1;
    }
    lem::st_pair<true>(dgxt + ra * H3 + p.col, dg1[0], dg1[1], oka);
    lem::st_pair<true>(dgxt + rb * H3 + p.col, dg1[2], dg1[3], okb);
    lem::st_pair<true>(dgxt + ra * H3 + 2 * H + p.col, dzc[0], dzc[1], oka);
    lem::st_pair<true>(dgxt + rb * H3 + 2 * H + p.col, dzc[2], dzc[3], okb);
    put2(dg_s + p.lr * DGP + lc, dg1[0], dg1[1]);
    put2(dg_s + (p.lr + 8) * DGP + lc, dg1[2], dg1[3]);
    put2(dg_s + p.lr * DGP + 2 * HC + lc, dzc[0], dzc[1]);
    put2(dg_s + (p.lr + 8) * DGP + 2 * HC + lc, dzc[2], dzc[3]);
    __syncthreads();  // dg of the CTA's columns complete
    LEM_PHASE(7);

    // dy += dg Wy^T, exchanged through the z rows
    {
      float part[C][4] = {};
      product_t<0, 3>(part, dg_s, DGP, wf, p);
#pragma unroll
      for (int k = 0; k < C; ++k)
        lem::st_cluster(lem::remote(zr_a, k), part[k]);
    }
    // arrive: the dy partials are out. The weight gradient reads only this
    // CTA's own buffers, so it runs while the cluster gathers.
    lem::cluster_arrive();
    LEM_PHASE(8);
    grad_w<0, 3>(dw, yr, dg_s, DGP, nwarps, p);
    LEM_PHASE(9);
    __syncthreads();  // every warp done with the y_prev rows
    if (t > 0) lem::load_rows(yr, y_prev(t - 1), row0, N, p);
    LEM_PHASE(10);
    lem::cluster_wait();  // dy partials in
    LEM_PHASE(11);

    const float4* zr4 = reinterpret_cast<const float4*>(zr);
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = 0.0f;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float4 v = zr4[(s * nwarps + p.warp) * 32 + p.lane];
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dy[e] = dy[e] * (1.0f - dt2[e]) + sum[e];
    __syncthreads();  // every warp done with the dy partials
    if (t > 0) lem::load_rows(zr, zs + (t - 1) * NH, row0, N, p);
    LEM_PHASE(12);
  }
  lem::st_pair<true>(dy0 + ia, dy[0], dy[1], oka);
  lem::st_pair<true>(dy0 + ib, dy[2], dy[3], okb);
  lem::st_pair<true>(dz0 + ia, dz[0], dz[1], oka);
  lem::st_pair<true>(dz0 + ib, dz[2], dz[3], okb);

  // this cluster's [dWy | dWzz] partial: [H, 3H] then [H, H]
  float* part = partial + (size_t)cluster * 4 * H * H;
  const int tiles = (H / 16) * p.WN;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tile = p.warp + u * nwarps;
    if (tile >= tiles) break;
    const int j = (tile / p.WN) * 16 + p.g;
    const int c = p.rank * HC + (tile % p.WN) * 8 + 2 * p.t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* out = q < 3 ? part + (size_t)j * 3 * H + q * H + c
                         : part + 3 * (size_t)H * H + (size_t)j * H + c;
      const int ld = q < 3 ? 3 * H : H;
      *reinterpret_cast<float2*>(out) = make_float2(dw[q][u][0], dw[q][u][1]);
      *reinterpret_cast<float2*>(out + 8 * ld) =
          make_float2(dw[q][u][2], dw[q][u][3]);
    }
  }
}

// dWy, dWzz = the sum over clusters, in order, of their partials.
__global__ void lem_bwd_reduce(const float* __restrict__ partial,
                               float* __restrict__ dwy,
                               float* __restrict__ dwzz, int clusters, int H) {
  const int n = 4 * H * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < clusters; ++c) s += partial[(size_t)c * n + i];
  if (i < 3 * H * H) dwy[i] = s;
  else dwzz[i - 3 * H * H] = s;
}

// ---- the hidden-164 route (lem_step.cuh, lem::gen) -------------------------
namespace gen = lem::gen;
constexpr int GEN_STAGES = 8;                  // ring stages
constexpr int GEN_TILES = 21 + 7 + 7 + 21;     // a step: Wy, Wzz, Wzz^T, Wy^T
constexpr int DGP = 3 * gen::HP + 4;           // the dg rows' pitch, floats
// y_prev and z_t rows (two of each), da rows, dg rows
constexpr int GEN_ROWF = 5 * gen::GR * gen::RP + gen::GR * DGP;
constexpr int WSPLIT = 22;  // row parts of lem_bwd_wgrad, summed in order
constexpr int WJ = 64;      // its rows j of dW a CTA: 4 m16 tiles
constexpr int WKC = 32;     // its rows m a chunk: 4 k-steps
constexpr int WAP = 72;     // a chunk's pitches: A [WKC][WJ], B [WKC][HP]
constexpr int WSTAGES = 3;  // chunks in flight
constexpr int WSTAGE = WKC * (WAP + gen::HP);
constexpr int WSMEM = 4 * WSTAGES * WSTAGE;

// wT [cols, rows] = w [rows, cols]^T, in 32 x 32 tiles through shared memory
__global__ void lem_transpose(const float* __restrict__ w,
                              float* __restrict__ wT, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = w[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && c < cols) wT[(size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

// The sweep: CTA b owns rows [b GR, (b + 1) GR) and every hidden column; its
// consumer warps hold dy and dz of their columns in registers. A step t: the
// y_prev and z_t rows are in (cp.async, loaded during the step before, two
// buffers of each); g = gx_t + y_prev Wy and a = zx_t + z_t Wzz (28 tiles;
// the two are independent, z_t being stashed); da and dg2 into their rows and
// a barrier of the consumer warps; dz += da Wzz^T (7 tiles), dg1 and dzc into
// their rows and a barrier; dy = dy (1 - dt2) + dg Wy^T (21 tiles, a k-step
// a gate). Each buffer is written after a barrier that follows its last
// read. The padded columns stay exactly zero: their inputs, weights and
// cotangents are.
__global__ void __launch_bounds__(gen::THREADS, 1)
lem_bwd_ring(const __grid_constant__ CUtensorMap map_wy,
             const __grid_constant__ CUtensorMap map_wzz,
             const __grid_constant__ CUtensorMap map_wzzT,
             const __grid_constant__ CUtensorMap map_wyT,
             const float* __restrict__ gx, const float* __restrict__ zx,
             const float* __restrict__ y0, const float* __restrict__ z0,
             const float* __restrict__ ys, const float* __restrict__ zs,
             const float* __restrict__ dyT, const float* __restrict__ dzT,
             float* __restrict__ dgx, float* __restrict__ dzx,
             float* __restrict__ dy0, float* __restrict__ dz0, int T, int N,
             float dt) {
  constexpr int H = gen::H, GR = gen::GR, HP = gen::HP, RP = gen::RP;
  constexpr int CW = gen::CW, KROWS = gen::KROWS, THREADS = gen::THREADS;
  constexpr int S = GEN_STAGES, ROWS = GR * RP;
  extern __shared__ __align__(1024) float4 gen_smem[];
  float* ring = reinterpret_cast<float*>(gen_smem);
  float* yp_s = ring + S * gen::STAGE_FLOATS;  // [2][GR][RP] y_prev rows
  float* zt_s = yp_s + 2 * ROWS;          // [2][GR][RP] z_t rows
  float* da_s = zt_s + 2 * ROWS;          // [GR][RP]
  float* dg_s = da_s + ROWS;              // [GR][DGP]: dg1 | dg2 | dzc
  uint64_t* bars = reinterpret_cast<uint64_t*>(dg_s + GR * DGP);
  GEN_PHASE_START(reinterpret_cast<unsigned long long*>(bars + 2 * S));
  const int rank = static_cast<int>(lem::cluster_rank());
  const uint32_t full0 = lem::smem_addr(bars), empty0 = full0 + 8 * S;
  for (int i = threadIdx.x; i < GEN_ROWF; i += THREADS) yp_s[i] = 0.0f;
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
    const CUtensorMap* m_wzzT = &map_wzzT;
    const CUtensorMap* m_wyT = &map_wyT;
    if (threadIdx.x == CW * 32)
      gen::produce<S>(full0, empty0, lem::smem_addr(ring), T * GEN_TILES, rank,
                 [&](int i, uint32_t dst, uint32_t bar, uint64_t policy) {
                   const int k = i % GEN_TILES;
                   if (k < 21)
                     gen::tma_multicast(dst, m_wy, bar, 0, 0, 8 * k, policy);
                   else if (k < 28)
                     gen::tma_multicast(dst, m_wzz, bar, 0, KROWS * (k - 21),
                                   0, policy);
                   else if (k < 35)
                     gen::tma_multicast(dst, m_wzzT, bar, 0, KROWS * (k - 28),
                                   0, policy);
                   else
                     gen::tma_multicast(dst, m_wyT, bar, 0, 8 * (k - 35), 0,
                                   policy);
                 });
    __syncwarp();
  } else {
    const gen::Lane l;
    gen::Ring<S> rg(full0, empty0, ring);
    const int row0 = blockIdx.x * GR;
    const size_t NH = (size_t)N * H;
    int row[2];
    bool rok[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      row[rr] = row0 + l.g + 8 * rr;
      rok[rr] = row[rr] < N;
    }
    auto ok = [&](int j, int rr) { return l.cok[j] && rok[rr]; };
    auto at = [&](auto* x, size_t base, int ld, int j, int rr) {
      return x + (base + row[rr]) * ld + l.col[j];
    };
    auto put = [&](float* buf, int pitch, const float (&v)[3][4]) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(buf + (l.g + 8 * rr) * pitch +
                                     l.col[j]) =
              make_float2(v[j][2 * rr], v[j][2 * rr + 1]);
    };
    auto out = [&](float* x, size_t base, int ld, const float (&v)[3][4]) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::st_pair<true>(at(x, base, ld, j, rr), v[j][2 * rr],
                             v[j][2 * rr + 1], ok(j, rr));
    };
    auto in = [&](float (&v)[3][4], const float* x, size_t base, int ld) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          lem::ld_pair(v[j] + 2 * rr, at(x, base, ld, j, rr), ok(j, rr));
    };
    float dy[3][4], dz[3][4];
    in(dy, dyT, 0, H);
    in(dz, dzT, 0, H);
    // gx_t, zx_t, z_prev of this thread's elements, a step ahead
    float pg[3][3][4], pa[1][3][4], pz[3][4];
    auto fetch = [&](int t) {
#pragma unroll
      for (int q = 0; q < 3; ++q) in(pg[q], gx + q * H, (size_t)t * N, 3 * H);
      in(pa[0], zx, (size_t)t * N, H);
      in(pz, t ? zs + (t - 1) * NH : z0, 0, H);
    };
    auto y_prev = [&](int t) { return t ? ys + (t - 1) * NH : y0; };
    if (T > 0) {
      fetch(T - 1);
      gen::load_rows(yp_s, y_prev(T - 1), row0, N);
      gen::load_rows(zt_s, zs + (T - 1) * NH, row0, N);
    }
    GEN_PHASE(0);
    for (int t = T - 1; t >= 0; --t) {
      const int b = (T - 1 - t) & 1;
      const float* yp = yp_s + b * ROWS;
      const float* zt = zt_s + b * ROWS;
      lem::cp_async_wait_all();
      gen::consumers_sync();  // this step's rows are in; the other buffers free
      GEN_PHASE(6);
      if (t > 0) {
        gen::load_rows(yp_s + (b ^ 1) * ROWS, y_prev(t - 1), row0, N);
        gen::load_rows(zt_s + (b ^ 1) * ROWS, zs + (t - 1) * NH, row0, N);
      }
      float g[3][3][4], a[1][3][4], zp[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g[0][j][e] = pg[0][j][e];
          g[1][j][e] = pg[1][j][e];
          g[2][j][e] = pg[2][j][e];
          a[0][j][e] = pa[0][j][e];
          zp[j][e] = pz[j][e];
        }
      if (t > 0) fetch(t - 1);

      // recompute the step, as the forward computes it
      const float* ya = yp + l.g * RP;
      const float* za = zt + l.g * RP;
      gen::product<1, 3, 3 * HP>(g, rg, 21, ya, ya + 8 * RP, 0, 8, 0, l.n0,
                                 l.t, l.lane);
      gen::product<3, 1, HP>(a, rg, 7, za, za + 8 * RP, 0, KROWS, 8, l.n0,
                             l.t, l.lane);
      GEN_PHASE_RING(rg);
      float s1[3][4], thz[3][4], dt2[3][4], da[3][4], dg2[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s1[j][e] = lem::sigm(g[0][j][e]);
          const float s2 = lem::sigm(g[1][j][e]);
          thz[j][e] = lem::tanh_(g[2][j][e]);
          const float tha = lem::tanh_(a[0][j][e]);
          const float y = ya[(e >> 1) * 8 * RP + l.col[j] + (e & 1)];
          dt2[j][e] = dt * s2;
          da[j][e] = dy[j][e] * dt2[j][e] * (1.0f - tha * tha);
          dg2[j][e] = dy[j][e] * (tha - y) * dt * s2 * (1.0f - s2);
        }
      GEN_PHASE(3);
      out(dzx, (size_t)t * N, H, da);
      out(dgx + H, (size_t)t * N, 3 * H, dg2);
      put(da_s, RP, da);
      put(dg_s + HP, DGP, dg2);
      GEN_PHASE(4);
      gen::consumers_sync();  // da complete
      GEN_PHASE(5);

      // dz += da Wzz^T
      float acc[1][3][4] = {};
      const float* daa = da_s + l.g * RP;
      gen::product<3, 1, HP>(acc, rg, 7, daa, daa + 8 * RP, 0, KROWS, 8, l.n0,
                             l.t, l.lane);
      GEN_PHASE_RING(rg);
      float dg1[3][4], dzc[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dz[j][e] += acc[0][j][e];
          const float dt1 = dt * s1[j][e];
          dg1[j][e] = dz[j][e] * (thz[j][e] - zp[j][e]) * dt * s1[j][e] *
                      (1.0f - s1[j][e]);
          dzc[j][e] = dz[j][e] * dt1 * (1.0f - thz[j][e] * thz[j][e]);
          dz[j][e] *= 1.0f - dt1;
          acc[0][j][e] = 0.0f;
        }
      GEN_PHASE(3);
      out(dgx, (size_t)t * N, 3 * H, dg1);
      out(dgx + 2 * H, (size_t)t * N, 3 * H, dzc);
      put(dg_s, DGP, dg1);
      put(dg_s + 2 * HP, DGP, dzc);
      GEN_PHASE(4);
      gen::consumers_sync();  // dg complete
      GEN_PHASE(5);

      // dy = dy (1 - dt2) + dg Wy^T: k-step q of tile jb reads gate q
      const float* dga = dg_s + l.g * DGP;
      gen::product<3, 1, HP>(acc, rg, 21, dga, dga + 8 * DGP, 0, 8, HP, l.n0,
                             l.t, l.lane);
      GEN_PHASE_RING(rg);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dy[j][e] = dy[j][e] * (1.0f - dt2[j][e]) + acc[0][j][e];
      GEN_PHASE(3);
    }
    out(dy0, 0, H, dy);
    out(dz0, 0, H, dz);
  }
  GEN_PHASE_END;
  lem::cluster_sync();  // no CTA leaves while the others may still signal it
}

// The weight gradients over the M = T N rows m = t N + n, on the tensor
// cores: CTA (tile, s) sums rows [s M', (s + 1) M') (M' = cdiv(M, WSPLIT))
// of one output tile into part s of `partial` ([H, 3H] then [H, H], the
// layout lem_bwd_reduce sums): rows j0 + [0, WJ) of dWy's gate ct (ct < 3;
// A rows y_prev: y0 at t = 0, else ys[t - 1], i.e. ys's flat row m - N; B
// rows dgx's gate ct) or of dWzz (ct = 3; A rows zs, B rows dzx), every
// column. Chunks of WKC rows of A and B stream through WSTAGES stages of
// shared memory (cp.async); warp w owns the n8 tiles 3w .. 3w + 2 of the
// HP columns and all four m16 tiles, in 3xTF32. Both operands are MN-major
// (rows m), loaded as fragments by hand from pitches that put a fragment's
// lanes on distinct banks.
__global__ void __launch_bounds__(gen::CW * 32, 2)
lem_bwd_wgrad(const float* __restrict__ y0, const float* __restrict__ ys,
              const float* __restrict__ zs, const float* __restrict__ dgx,
              const float* __restrict__ dzx, float* __restrict__ partial,
              int M, int N) {
  using gen::H;
  using gen::HP;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int jt = blockIdx.x % 3, ct = blockIdx.x / 3, j0 = WJ * jt;
  const int chunk = (M + WSPLIT - 1) / WSPLIT;
  const int m0 = blockIdx.y * chunk, m1 = min(M, m0 + chunk);
  const int chunks = m1 > m0 ? (m1 - m0 + WKC - 1) / WKC : 0;
  const gen::Lane l;
  auto load = [&](int c) {
    float* A = sm + (c % WSTAGES) * WSTAGE;
    float* B = A + WKC * WAP;
    const int mb = m0 + c * WKC;
    constexpr int PA = WJ / 4, PB = HP / 4;  // 16-byte pieces a row
    for (int i = threadIdx.x; i < WKC * (PA + PB); i += gen::CW * 32) {
      if (i < WKC * PA) {
        const int r = i / PA, j = j0 + (i % PA) * 4, m = mb + r;
        const bool ok = m < m1 && j < H;
        const float* src =
            ct < 3 ? (m < N ? y0 + (size_t)m * H : ys + (size_t)(m - N) * H)
                   : zs + (size_t)m * H;
        lem::cp_async16(lem::smem_addr(A + r * WAP + (i % PA) * 4),
                        ok ? src + j : y0, ok);
      } else {
        const int k = i - WKC * PA, r = k / PB, c4 = (k % PB) * 4;
        const int m = mb + r;
        const bool ok = m < m1 && c4 < H;
        const float* src = ct < 3 ? dgx + (size_t)m * 3 * H + ct * H
                                  : dzx + (size_t)m * H;
        lem::cp_async16(lem::smem_addr(B + r * HP + c4), ok ? src + c4 : y0,
                        ok);
      }
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;" ::: "memory"); };
  float acc[4][3][4] = {};
#pragma unroll
  for (int c = 0; c < WSTAGES - 1; ++c) {
    if (c < chunks) load(c);
    commit();
  }
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;" :: "n"(WSTAGES - 2) : "memory");
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + WSTAGES - 1 < chunks) load(c + WSTAGES - 1);
    commit();
    const float* A = sm + (c % WSTAGES) * WSTAGE;
    const float* B = A + WKC * WAP;
#pragma unroll
    for (int ks = 0; ks < WKC / 8; ++ks) {
      const float* a0 = A + (8 * ks + l.t) * WAP + l.g;
      const float* b0 = B + (8 * ks + l.t) * HP + l.n0;
      uint32_t ab[4][4], as[4][4], bb[3][2], bs[3][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        lem::split_tf32(a0[16 * mi], ab[mi][0], as[mi][0]);
        lem::split_tf32(a0[16 * mi + 8], ab[mi][1], as[mi][1]);
        lem::split_tf32(a0[4 * WAP + 16 * mi], ab[mi][2], as[mi][2]);
        lem::split_tf32(a0[4 * WAP + 16 * mi + 8], ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 3; ++nj) {
        lem::split_tf32(b0[8 * nj], bb[nj][0], bs[nj][0]);
        lem::split_tf32(b0[4 * HP + 8 * nj], bb[nj][1], bs[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 3; ++nj)
          lem::mma_tf32(acc[mi][nj], as[mi], bb[nj]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 3; ++nj)
          lem::mma_tf32(acc[mi][nj], ab[mi], bs[nj]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 3; ++nj)
          lem::mma_tf32(acc[mi][nj], ab[mi], bb[nj]);
    }
  }
  float* part = partial + (size_t)blockIdx.y * 4 * H * H;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 3; ++nj) {
      if (!l.cok[nj]) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + 16 * mi + l.g + 8 * rr;
        if (j >= H) continue;
        float* o = ct < 3 ? part + (size_t)j * 3 * H + ct * H + l.col[nj]
                          : part + 3 * (size_t)H * H + (size_t)j * H +
                                l.col[nj];
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[mi][nj][2 * rr], acc[mi][nj][2 * rr + 1]);
      }
    }
}

unsigned long long g_smem_set;   // allow_smem
unsigned long long g_ring_set;   // allow_smem, the hidden-164 sweep
unsigned long long g_wgrad_set;  // allow_smem, its weight gradients

}  // namespace

LEM_PHASE_READER(lem_bwd)

// Shared memory of a CTA at hidden H (at 164, of the sweep: the ring, the
// row buffers and the barriers)
extern "C" int lem_bwd_smem_bytes(int H) {
  if (lem::ring_width(H)) return gen::smem_bytes(GEN_STAGES, GEN_ROWF);
  const int HC = H / C;
  return (4 * H * HC + 3 * RT * H + RT * (HC + 4) + RT * (3 * HC + 4)) *
         (int)sizeof(float);
}

// Rows a CTA holds at hidden H: at 164 its own GR, at 96 and 128 its
// cluster's RT (each CTA a slice of the columns)
extern "C" int lem_bwd_cta_rows(int H) {
  return lem::ring_width(H) ? gen::GR : RT;
}

// Clusters the card holds at once (0: none can be scheduled), or -(error)
extern "C" int lem_bwd_max_clusters(int H) {
  if (lem::ring_width(H))
    return lem::max_clusters(reinterpret_cast<const void*>(lem_bwd_ring),
                             &g_ring_set, gen::THREADS, lem_bwd_smem_bytes(H));
  if (!lem::cluster_width(H)) return -(int)cudaErrorInvalidValue;
  return lem::max_clusters(reinterpret_cast<const void*>(lem_bwd_sweep),
                           &g_smem_set, threads(H), lem_bwd_smem_bytes(H));
}

// Floats of lem_bwd's `partial` scratch: the clusters' weight gradients,
// cdiv(N, RT) 4 H^2; at hidden 164 WSPLIT parts of 4 H^2 and the transposed
// weights, 4 H^2.
extern "C" long lem_bwd_scratch_floats(int N, int H) {
  if (lem::ring_width(H)) return (long)(WSPLIT + 1) * 4 * H * H;
  return (long)((N + RT - 1) / RT) * 4 * H * H;
}

// H is 96 or 128 (the clusters) or 164 (the hidden-164 route: the two
// transposes, the sweep, the weight gradients and their sum; wy, wzz and
// partial 16-byte aligned)
extern "C" int lem_bwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       const float* ys, const float* zs, const float* dyT,
                       const float* dzT, float* dgx, float* dzx, float* dy0,
                       float* dz0, float* dwy, float* dwzz, float* partial,
                       int T, int N, int H, float dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lem::ring_width(H)) {
    float* wyT = partial + (size_t)WSPLIT * 4 * H * H;
    float* wzzT = wyT + 3 * (size_t)H * H;
    cudaError_t err = lem::allow_smem(
        reinterpret_cast<const void*>(lem_bwd_ring), &g_ring_set);
    if (err == cudaSuccess)
      err = lem::allow_smem(reinterpret_cast<const void*>(lem_bwd_wgrad),
                            &g_wgrad_set);
    CUtensorMap map_wy, map_wzz, map_wzzT, map_wyT;
    if (err == cudaSuccess) err = gen::map_wy(&map_wy, wy);
    if (err == cudaSuccess) err = gen::map_square(&map_wzz, wzz);
    if (err == cudaSuccess) err = gen::map_square(&map_wzzT, wzzT);
    if (err == cudaSuccess) err = gen::map_wyT(&map_wyT, wyT);
    if (err != cudaSuccess) return (int)err;
    const dim3 tb(32, 8);
    lem_transpose<<<dim3((3 * H + 31) / 32, (H + 31) / 32), tb, 0, st>>>(
        wy, wyT, H, 3 * H);
    lem_transpose<<<dim3((H + 31) / 32, (H + 31) / 32), tb, 0, st>>>(
        wzz, wzzT, H, H);
    lem::ClusterLaunch l((N + C * gen::GR - 1) / (C * gen::GR) * C,
                         gen::THREADS, lem_bwd_smem_bytes(H), st);
    err = cudaLaunchKernelEx(&l.cfg, lem_bwd_ring, map_wy, map_wzz, map_wzzT,
                             map_wyT, gx, zx, y0, z0, ys, zs, dyT, dzT, dgx,
                             dzx, dy0, dz0, T, N, dt);
    if (err != cudaSuccess) return (int)err;
    lem_bwd_wgrad<<<dim3(3 * 4, WSPLIT), gen::CW * 32, WSMEM, st>>>(
        y0, ys, zs, dgx, dzx, partial, T * N, N);
    lem_bwd_reduce<<<(4 * H * H + 255) / 256, 256, 0, st>>>(partial, dwy,
                                                            dwzz, WSPLIT, H);
    return (int)cudaGetLastError();
  }
  if (!lem::cluster_width(H)) return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(lem_bwd_sweep);
  cudaError_t err = lem::allow_smem(kernel, &g_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (N + RT - 1) / RT;
  lem::ClusterLaunch l(clusters * C, threads(H), lem_bwd_smem_bytes(H), st);
  err = cudaLaunchKernelEx(&l.cfg, lem_bwd_sweep, gx, zx, y0, z0, wy, wzz, ys,
                           zs, dyT, dzT, dgx, dzx, dy0, dz0, partial, T, N, H,
                           dt);
  if (err != cudaSuccess) return (int)err;
  lem_bwd_reduce<<<(4 * H * H + 255) / 256, 256, 0, st>>>(partial, dwy, dwzz,
                                                          clusters, H);
  return (int)cudaGetLastError();
}
