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
// the width-generic route), and plain kernels take the launch:
// lem_transpose writes Wy^T and Wzz^T once (so that the transposed
// products read the weights coalesced); lem_bwd_generic runs the sweep on
// blocks of 192 threads over 16 rows, thread j on hidden column j, with the
// weights read from L2 each step (four products a step, float32 FMAs), and
// writes dgx, dzx, dy0, dz0; lem_bwd_wgrad then forms dWy = sum y_prev^T
// dgx and dWzz = sum z_t^T dzx over the T N rows as 64 x 64 output tiles,
// the rows split in WSPLIT parts, and lem_bwd_reduce sums the parts in
// order. No atomics: bitwise repeatable.
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

// ---- the generic route (hidden 164) ----------------------------------------
namespace gen = lem::gen;
constexpr int WSPLIT = 8;  // row parts of lem_bwd_wgrad, summed in order
constexpr int WT = 64;     // lem_bwd_wgrad's output tile, WT x WT
constexpr int WK = 16;     // its rows a step

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

// The sweep: block b owns rows [b GR, (b + 1) GR), thread j < H their
// column j of dy and dz in registers. A step t: the y_prev and z_t rows
// into shared memory (k-major); a barrier; g = gx_t + y_prev Wy and
// a = zx_t + z_t Wzz of the thread's column, da and dg2 into their rows;
// a barrier; dz += da Wzz^T, dg1 and dzc into their rows; a barrier;
// dy = dy (1 - dt2) + dg Wy^T. Each buffer is written after a barrier that
// follows its last read.
__global__ void __launch_bounds__(gen::MAX_H, 1)
lem_bwd_generic(const float* __restrict__ gx, const float* __restrict__ zx,
                const float* __restrict__ y0, const float* __restrict__ z0,
                const float* __restrict__ wy, const float* __restrict__ wzz,
                const float* __restrict__ wyT, const float* __restrict__ wzzT,
                const float* __restrict__ ys, const float* __restrict__ zs,
                const float* __restrict__ dyT, const float* __restrict__ dzT,
                float* __restrict__ dgx, float* __restrict__ dzx,
                float* __restrict__ dy0, float* __restrict__ dz0, int T, int N,
                int H, float dt) {
  constexpr int GR = gen::GR, GP = gen::GP;
  extern __shared__ float4 smem4[];
  float* yp_s = reinterpret_cast<float*>(smem4);  // [H][GP] y_prev
  float* zc_s = yp_s + H * GP;                    // [H][GP] z_t
  float* da_s = zc_s + H * GP;                    // [H][GP] da
  float* dg_s = da_s + H * GP;                    // [3H][GP] dg1 dg2 dzc
  const int j = threadIdx.x, row0 = blockIdx.x * GR;
  const bool on = j < H;
  const size_t NH = (size_t)N * H;
  float dy[GR], dz[GR];
  if (on) {
    gen::load_col(dy, dyT, row0, N, H, j);
    gen::load_col(dz, dzT, row0, N, H, j);
  }
  for (int t = T - 1; t >= 0; --t) {
    float yp[GR], zp[GR];
    if (on) {
      float zc[GR];
      gen::load_col(yp, t > 0 ? ys + (t - 1) * NH : y0, row0, N, H, j);
      gen::load_col(zp, t > 0 ? zs + (t - 1) * NH : z0, row0, N, H, j);
      gen::load_col(zc, zs + t * NH, row0, N, H, j);
      gen::put_col(yp_s, yp, j);
      gen::put_col(zc_s, zc, j);
    }
    __syncthreads();  // the y_prev and z_t rows are in
    float s1[GR], thz[GR], dt2[GR];
    if (on) {
      float g[3][GR] = {}, a[1][GR] = {};
      gen::product<3>(g, yp_s, wy, 3 * H, H, j, H);
      gen::product<1>(a, zc_s, wzz, H, 0, j, H);
      float p[3][GR], pa[GR], da[GR], dg2[GR];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        gen::load_col(p[q], gx + t * NH * 3 + q * H, row0, N, 3 * H, j);
      gen::load_col(pa, zx + t * NH, row0, N, H, j);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        s1[r] = lem::sigm(g[0][r] + p[0][r]);
        const float s2 = lem::sigm(g[1][r] + p[1][r]);
        thz[r] = lem::tanh_(g[2][r] + p[2][r]);
        const float tha = lem::tanh_(a[0][r] + pa[r]);
        dt2[r] = dt * s2;
        da[r] = dy[r] * dt2[r] * (1.0f - tha * tha);
        dg2[r] = dy[r] * (tha - yp[r]) * dt * s2 * (1.0f - s2);
      }
      gen::store_col(dzx + t * NH, da, row0, N, H, j);
      gen::store_col(dgx + t * NH * 3 + H, dg2, row0, N, 3 * H, j);
      gen::put_col(da_s, da, j);
      gen::put_col(dg_s, dg2, H + j);
    }
    __syncthreads();  // da complete
    if (on) {
      float acc[1][GR] = {}, dg1[GR], dzc[GR];
      gen::product<1>(acc, da_s, wzzT, H, 0, j, H);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        dz[r] += acc[0][r];
        const float dt1 = dt * s1[r];
        dg1[r] = dz[r] * (thz[r] - zp[r]) * dt * s1[r] * (1.0f - s1[r]);
        dzc[r] = dz[r] * dt1 * (1.0f - thz[r] * thz[r]);
        dz[r] *= 1.0f - dt1;
      }
      gen::store_col(dgx + t * NH * 3, dg1, row0, N, 3 * H, j);
      gen::store_col(dgx + t * NH * 3 + 2 * H, dzc, row0, N, 3 * H, j);
      gen::put_col(dg_s, dg1, j);
      gen::put_col(dg_s, dzc, 2 * H + j);
    }
    __syncthreads();  // dg complete
    if (on) {
      float acc[1][GR] = {};
      gen::product<1>(acc, dg_s, wyT, H, 0, j, 3 * H);
#pragma unroll
      for (int r = 0; r < GR; ++r) dy[r] = dy[r] * (1.0f - dt2[r]) + acc[0][r];
    }
  }
  if (on) {
    gen::store_col(dy0, dy, row0, N, H, j);
    gen::store_col(dz0, dz, row0, N, H, j);
  }
}

// The weight gradients over the M = T N rows m = t N + n: block (jt, kt, s)
// sums rows [s M', (s + 1) M') (M' = cdiv(M, WSPLIT)) of one WT x WT tile
// of [dWy | dWzz] into part s of `partial` ([H, 3H] then [H, H], the layout
// lem_bwd_reduce sums). dWy's A rows are y_prev (y0 at t = 0, else
// ys[t - 1], i.e. ys's flat row m - N), its B rows dgx; dWzz's A rows zs,
// its B rows dzx. Thread (ty, tx) of 16 x 16 holds a 4 x 4 piece.
__global__ void __launch_bounds__(256)
lem_bwd_wgrad(const float* __restrict__ y0, const float* __restrict__ ys,
              const float* __restrict__ zs, const float* __restrict__ dgx,
              const float* __restrict__ dzx, float* __restrict__ partial,
              int M, int N, int H) {
  __shared__ __align__(16) float a_s[WK][WT];
  __shared__ __align__(16) float b_s[WK][WT];
  const int jy = (3 * H + WT - 1) / WT;  // dWy's column tiles
  const bool zz = (int)blockIdx.x >= jy;
  const int j0 = (zz ? (int)blockIdx.x - jy : (int)blockIdx.x) * WT;
  const int k0 = blockIdx.y * WT, ncol = zz ? H : 3 * H;
  const float* B = zz ? dzx : dgx;
  const int chunk = (M + WSPLIT - 1) / WSPLIT;
  const int m0 = blockIdx.z * chunk, m1 = min(M, m0 + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int mb = m0; mb < m1; mb += WK) {
#pragma unroll
    for (int i = 0; i < WK * WT / 256; ++i) {
      const int e = tid + 256 * i, mm = e / WT, c = e % WT, m = mb + mm;
      const bool row = m < m1;
      const float* a = zz ? zs + (size_t)m * H
                          : (m < N ? y0 + (size_t)m * H
                                   : ys + (size_t)(m - N) * H);
      a_s[mm][c] = row && k0 + c < H ? a[k0 + c] : 0.0f;
      b_s[mm][c] = row && j0 + c < ncol ? B[(size_t)m * ncol + j0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < WK; ++mm) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[mm][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[mm][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }
  float* part = partial + (size_t)blockIdx.z * 4 * H * H +
                (zz ? 3 * (size_t)H * H : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = j0 + tx * 4 + q;
      if (c < ncol) part[(size_t)k * ncol + c] = acc[i][q];
    }
  }
}

unsigned long long g_smem_set;     // allow_smem
unsigned long long g_generic_set;  // allow_smem, generic route

}  // namespace

LEM_PHASE_READER(lem_bwd)

// Shared memory of a CTA at hidden H
extern "C" int lem_bwd_smem_bytes(int H) {
  if (lem::generic_width(H))  // y_prev, z_t, da and dg rows, k-major
    return 6 * H * gen::GP * (int)sizeof(float);
  const int HC = H / C;
  return (4 * H * HC + 3 * RT * H + RT * (HC + 4) + RT * (3 * HC + 4)) *
         (int)sizeof(float);
}

// Clusters the card holds at once (0: none can be scheduled), or -(error)
// (the generic route: blocks of the sweep, a cluster of one)
extern "C" int lem_bwd_max_clusters(int H) {
  if (lem::generic_width(H))
    return gen::max_blocks(reinterpret_cast<const void*>(lem_bwd_generic),
                           &g_generic_set, gen::threads(H),
                           lem_bwd_smem_bytes(H));
  if (!lem::cluster_width(H)) return -(int)cudaErrorInvalidValue;
  return lem::max_clusters(reinterpret_cast<const void*>(lem_bwd_sweep),
                           &g_smem_set, threads(H), lem_bwd_smem_bytes(H));
}

// Floats of lem_bwd's `partial` scratch: the clusters' weight gradients,
// cdiv(N, RT) 4 H^2; on the generic route WSPLIT parts of 4 H^2 and the
// transposed weights, 4 H^2.
extern "C" long lem_bwd_scratch_floats(int N, int H) {
  if (lem::generic_width(H)) return (long)(WSPLIT + 1) * 4 * H * H;
  return (long)((N + RT - 1) / RT) * 4 * H * H;
}

// H is 96 or 128 (the clusters) or 164 (the generic route)
extern "C" int lem_bwd(const float* gx, const float* zx, const float* y0,
                       const float* z0, const float* wy, const float* wzz,
                       const float* ys, const float* zs, const float* dyT,
                       const float* dzT, float* dgx, float* dzx, float* dy0,
                       float* dz0, float* dwy, float* dwzz, float* partial,
                       int T, int N, int H, float dt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lem::generic_width(H)) {
    const void* kernel = reinterpret_cast<const void*>(lem_bwd_generic);
    cudaError_t err = lem::allow_smem(kernel, &g_generic_set);
    if (err != cudaSuccess) return (int)err;
    float* wyT = partial + (size_t)WSPLIT * 4 * H * H;
    float* wzzT = wyT + 3 * (size_t)H * H;
    const dim3 tb(32, 8);
    lem_transpose<<<dim3((3 * H + 31) / 32, (H + 31) / 32), tb, 0, st>>>(
        wy, wyT, H, 3 * H);
    lem_transpose<<<dim3((H + 31) / 32, (H + 31) / 32), tb, 0, st>>>(
        wzz, wzzT, H, H);
    lem_bwd_generic<<<(N + gen::GR - 1) / gen::GR, gen::threads(H),
                      lem_bwd_smem_bytes(H), st>>>(
        gx, zx, y0, z0, wy, wzz, wyT, wzzT, ys, zs, dyT, dzT, dgx, dzx, dy0,
        dz0, T, N, H, dt);
    const int tiles = (3 * H + WT - 1) / WT + (H + WT - 1) / WT;
    lem_bwd_wgrad<<<dim3(tiles, (H + WT - 1) / WT, WSPLIT), 256, 0, st>>>(
        y0, ys, zs, dgx, dzx, partial, T * N, N, H);
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
