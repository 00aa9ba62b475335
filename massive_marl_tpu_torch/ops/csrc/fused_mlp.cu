// Fused Dense -> ELU -> LayerNorm block, forward (B2) and backward (B3), for
// agent-stacked operands: CUDA C++ for sm_90a, both on wgmma fed by TMA
// through mbarrier rings of shared-memory tiles.
//
// Replaces the TPU kernels massive_marl_tpu/ops/fused_mlp.py::_fwd_kernel
// (B2) and ::_bwd_kernel (B3).  The plain PyTorch versions with the same
// roundings are massive_marl_tpu_torch/ops/fused_mlp.py::fwd_plain and
// ::bwd_plain.
//
// Per agent n (x [N,B,Din] bf16 with agent stride sx, which is 0 when every
// agent reads the same rows; w [N,Din,H] bf16; vectors f32):
//   forward:  xt = bf16(x*g0 + b0); h = xt @ w + b (f32 accumulation);
//             a = h > 0 ? h : exp(h) - 1; y = (a - mu) * rsqrt(var + eps) *
//             gamma + beta with the population variance; y and a stored bf16.
//   backward: the LayerNorm and ELU backward from a and dy; dh16 = bf16(dh)
//             feeds both products; dx = bf16((dh16 @ w^T) * g0); dW = xt^T @
//             dh16; db = sum dh (f32 dh); dgamma = sum dy*yhat; dbeta = sum
//             dy; dg0 = sum (dh16 @ w^T) * x; db0 = sum dh16 @ w^T.
//
// B2 (forward, dense_fwd_wgmma_kernel: fwd_body of fused_mlp_common.cuh
// with one layer).  What bounds it on this card: bytes.  At hidden
// 512->512, N = 1 (B = 32,768) it must move 101 MB (x, y and a, W once) and
// do 17.2 GFLOP, 0.030 ms against 0.017 ms.  So the design keeps every
// load in flight under the math and reads W from L2 as rarely as it can:
//   * a persistent grid of 2-block clusters walks work items (two 64-row
//     blocks of one agent), so a producer warp keeps a ring of K stages in
//     flight across items: the next item's x and W land while this item's
//     epilogue and stores run;
//   * x streams through the ring with W (no Din limit); the consumers apply
//     the input affine in place, one 16-byte chunk each, before wgmma reads
//     the tile;
//   * each W tile is loaded from L2 once per cluster and multicast to both
//     blocks (a stage is refilled when the four consumer warpgroups of the
//     cluster have released it);
//   * two consumer warpgroups hold the 64 x H f32 product in registers; the
//     bias/ELU/LayerNorm epilogue works from them, with the row statistics
//     across the warpgroups through a 512-byte buffer, so no f32 tile
//     passes through shared memory;
//   * a and y are staged as swizzled bf16 in shared memory and leave by TMA
//     stores, which run on under the next item's products.
//
// B3 (backward).  The TPU kernel walks the row blocks of one agent in order
// and accumulates the column sums and dW in place across grid steps.
// Blocks run in no order here, so the backward is a row pass, the dW pass
// and fixed-order reductions, with no atomics: the same bits on every run.
//   1. The row pass (ln_bwd_rows_wgmma_kernel) is persistent: one block per
//      SM walks work items of 128 rows of one agent.  A producer warp keeps
//      a ring of three 16 KB W tiles in flight by TMA and then loads the x
//      rows of each 128-column chunk of dx; two consumer warpgroups own 64
//      rows each.  They run the LayerNorm/ELU backward one warp per row,
//      with 8-byte loads in the column order of torch's own row sums (so
//      the statistics, and the roundings of dh16, match the plain
//      version's; see torch_lane_sum), writing dh16 to shared memory
//      (128-byte swizzle, the wgmma A operand) and to the dh scratch; then
//      per chunk dx_raw = dh16 @ w^T on wgmma with the accumulator in
//      registers, dx = bf16(dx_raw * g0), and the per-block sums of dx_raw
//      * x and dx_raw from the accumulator (quads by shuffles, warps through
//      shared memory, fixed order).  Persistence, rather than two blocks per
//      SM, hides the next item's first W tiles behind this item's epilogue:
//      dh16 of 128 rows (128 KB at H = 512) leaves no room for a second
//      block.
//   2. The dW pass (fused_mlp_common.cuh, shared with B5): dW = xt^T @ dh16
//      on wgmma from a six-stage TMA ring, split over rows to fill the card.
//   3. colsum_*: the per-block sums reduced over the card in two fixed-order
//      levels.
// What bounds it on this card: at hidden 512->512, N = 1 B3 is balanced,
// 0.0413 ms by operations (two products, 34.4 GFLOP, and the elementwise
// work) and ~0.0405 ms by bytes.  What still holds the row pass back is its
// own epilogue work: the LayerNorm phase walks 16 rows per warp in
// sequence, the column sums take shuffles, and one block per SM overlaps
// none of that with the products.

#include "fused_mlp_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B2: forward
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(RP_THREADS, 1)
dense_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, int N, int B, int Din, int x_agents,
                       const float* __restrict__ g0, const float* __restrict__ b0,
                       const __grid_constant__ Layers p) {
  fwd_body<HK>(maps, N, B, Din, 1, x_agents, true, g0, b0, p);
}

// ---------------------------------------------------------------------------
// B3: backward, the row pass
// ---------------------------------------------------------------------------

constexpr int R3_ROWS = 128;   // rows of a work item, 64 per consumer warpgroup
constexpr int R3_NC = 128;     // dx columns per chunk
constexpr int R3_KD = 64;      // depth (along H) of a W tile
constexpr int R3_STAGES = 3;
constexpr uint32_t R3_STAGE_BYTES = R3_NC * R3_KD * 2;  // 16 KB
constexpr uint32_t R3_ATOM = R3_ROWS * 128;            // 128 rows x 64 columns of bf16

// Shared memory of the row pass at width H; every tile is K-major with the
// 128-byte swizzle, in atoms of 64 columns:
//   dhs   dh16 [128 rows][H] as H / 64 atoms (the A operand);
//   ring  R3_STAGES W tiles [128 Din rows][64 H] (the B operand);
//   uni   the warps' LayerNorm partials [8][3][H] f32 while phase 1 runs,
//         then the x chunk [128 rows][128] (two atoms) and the warps'
//         dg0/db0 partials [8][2][128] f32 of each dx chunk;
//   bars  full/empty per ring stage, x full/empty.
struct RowsSmem {
  size_t ring, uni, cred, bars, total;
};

__host__ __device__ inline RowsSmem rows_layout(int H) {
  RowsSmem s;
  s.ring = align1k((size_t)R3_ROWS * H * 2);
  s.uni = s.ring + R3_STAGES * R3_STAGE_BYTES;
  s.cred = s.uni + 2 * R3_ATOM;
  const size_t red = (size_t)8 * 3 * H * 4, xc = s.cred - s.uni + (size_t)8 * 2 * R3_NC * 4;
  s.bars = s.uni + (red > xc ? red : xc);
  s.total = s.bars + (2 * R3_STAGES + 2) * 8;
  return s;
}

// A row sum over a warp in the order of torch's CUDA sum over the last axis
// of a contiguous f32 row (its vectorized path), so that the row statistics,
// and through them the roundings of dh16, match the plain version's: lane x
// holds columns 4x + 128k + e in 4 accumulators (one per e, summed over k in
// order), combines them in order (torch_lane_sum), and a butterfly over the
// warp adds the lanes (warp_sum).  The order was checked against torch's
// sum and mean on the card, on every row, at each H the kernel takes.
template <int KG, typename F>
__device__ __forceinline__ float torch_lane_sum(F f) {
  float acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] = f(0, e);
#pragma unroll
    for (int k = 1; k < KG; ++k) acc[e] += f(k, e);
  }
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// warp_sum of two lane sums at once (independent shuffle chains).
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// The bf16 pair at (row, col) of the staged x chunk (two swizzled atoms).
__device__ __forceinline__ __nv_bfloat162 x_pair(const unsigned char* xb, int row, int col) {
  return *reinterpret_cast<const __nv_bfloat162*>(
      xb + (col >> 6) * R3_ATOM + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// Persistent over work items (agent n, 128-row block): blocks walk items
// blockIdx.x, + gridDim.x, ...  The producer warp streams by TMA, per item
// and 128-column chunk of Din, the W tiles of the chunk through the ring and
// then the chunk's x rows (rows past B read as zeros); the W stream of the
// next item starts while the consumers still finish this one.  The consumers:
//   1. LayerNorm and ELU backward, one warp per row, 16-byte loads: dh16 to
//      shared memory and to the dh scratch; per-block sums of dh, dy*yhat
//      and dy, the warps summed in a fixed order;
//   2. per chunk, dx_raw = dh16 @ w^T on wgmma (A dh16 from shared memory,
//      B the W tiles), the accumulator in registers; then dx = bf16(dx_raw
//      * g0) and the per-block sums of dx_raw * x and dx_raw (quads by
//      shuffles, warps through shared memory, fixed order).
template <int HK>
__global__ void __launch_bounds__(RP_THREADS, 1)
ln_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap, int N, int B, int Din,
                         int x_agents, int nblk, const bf16* __restrict__ dy,
                         const bf16* __restrict__ a, const float* __restrict__ gamma,
                         const float* __restrict__ g0,
                         bf16* __restrict__ dx, bf16* __restrict__ dh_out,
                         float* __restrict__ part) {
  constexpr int H = 128 * HK;
  constexpr int KG = H / 128;            // groups of 4 columns per lane in the LayerNorm phase
  constexpr float INV_H = 1.f / H;       // a mean is the sum times 1/H, as torch's mean computes it
  extern __shared__ __align__(1024) unsigned char smem[];
  const RowsSmem L = rows_layout(H);
  unsigned char* dhs = smem;
  float* red = reinterpret_cast<float*>(smem + L.uni);
  unsigned char* xb = smem + L.uni;
  float* cred = reinterpret_cast<float*>(smem + L.cred);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + R3_STAGES;
  uint64_t* xfull = empty + R3_STAGES;
  uint64_t* xempty = xfull + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    ring_init(full, empty, R3_STAGES);
    mbar_init(xfull, 1);
    mbar_init(xempty, 2);
  }
  mbar_init_fence();
  __syncthreads();
  Ring ring{full, empty, smem + L.ring, R3_STAGE_BYTES, R3_STAGES, 0, 0};
  const int items = N * nblk, nchunks = Din / R3_NC;
  const int P = 3 * H + 2 * Din;

  if (warp >= 8) {  // ---- producer
    regs_dealloc<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int xp = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int n = item / nblk, row0 = (item % nblk) * R3_ROWS, nx = x_agents > 1 ? n : 0;
        for (int dc = 0; dc < nchunks; ++dc) {
          for (int kt = 0; kt < H / R3_KD; ++kt) {
            ring.producer_acquire();
            mbar_expect_tx(&full[ring.stage], R3_STAGE_BYTES);
            tma_load(ring.buf(), &wmap, &full[ring.stage], kt * R3_KD, dc * R3_NC, n);
            ring.advance();
          }
          mbar_wait(xempty, xp);  // the consumers are done with the region
          xp ^= 1;
          mbar_expect_tx(xfull, 2 * R3_ATOM);
          tma_load(xb, &xmap, xfull, dc * R3_NC, row0, nx);
          tma_load(xb + R3_ATOM, &xmap, xfull, dc * R3_NC + 64, row0, nx);
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    // ---- consumers: warpgroup wg owns rows 64 wg ... of each item
    const int wg = warp >> 2, wl = warp & 3;
    const bool elected = (tid & 127) == 0;
    int xfp = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int n = item / nblk, row0 = (item % nblk) * R3_ROWS;
      float* pn = part + (size_t)item * P;

      // ---- 1. LayerNorm and ELU backward, warp `warp` on rows 16 warp ...
      {
        const float* gn = gamma + (size_t)n * H;
        // lane x holds columns col(k, e) = 4x + 128k + e (torch's order for a
        // mean over the last axis, torch_lane_sum)
        auto col = [&](int k, int e) { return 4 * lane + 128 * k + e; };
        float gv[KG][4], pdb[KG][4], pdg[KG][4], pdbe[KG][4];
#pragma unroll
        for (int k = 0; k < KG; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gv[k][e] = gn[col(k, e)];
            pdb[k][e] = pdg[k][e] = pdbe[k][e] = 0.f;
          }
        const size_t nb0 = (size_t)n * B;
        bf16 an[KG][4], dn[KG][4];  // the next row's a and dy, loaded ahead
        auto load_row = [&](int r) {
          const int gr = min(row0 + r, B - 1);
          const bf16* ar = a + (nb0 + gr) * H;
          const bf16* dr = dy + (nb0 + gr) * H;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            *reinterpret_cast<uint2*>(an[k]) = *reinterpret_cast<const uint2*>(ar + col(k, 0));
            *reinterpret_cast<uint2*>(dn[k]) = *reinterpret_cast<const uint2*>(dr + col(k, 0));
          }
        };
        load_row(warp * 16);
        for (int rr = 0; rr < 16; ++rr) {
          const int r = warp * 16 + rr, gr = row0 + r;
          float av[KG][4], dv[KG][4];
#pragma unroll
          for (int k = 0; k < KG; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              av[k][e] = __bfloat162float(an[k][e]);
              dv[k][e] = __bfloat162float(dn[k][e]);
            }
          if (rr + 1 < 16) load_row(r + 1);
          // the bf16 at column c of row r: atom c / 64, 16-byte chunk (c % 64) / 8
          // swizzled with r % 8
          auto dh_smem = [&](int c) {
            return reinterpret_cast<uint2*>(dhs + (c >> 6) * R3_ATOM + r * 128 +
                                            ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
          };
          if (gr >= B) {  // rows past B: zeros in shared memory, nothing else
#pragma unroll
            for (int k = 0; k < KG; ++k) *dh_smem(col(k, 0)) = make_uint2(0, 0);
            continue;
          }
          const float mu = warp_sum(torch_lane_sum<KG>([&](int k, int e) { return av[k][e]; })) * INV_H;
          const float inv = rsqrtf(warp_sum(torch_lane_sum<KG>([&](int k, int e) {
                                     const float d = av[k][e] - mu;
                                     return d * d;
                                   })) * INV_H + EPS);
          float m1 = torch_lane_sum<KG>([&](int k, int e) { return dv[k][e] * gv[k][e]; });
          float m2 = torch_lane_sum<KG>([&](int k, int e) {
            return (dv[k][e] * gv[k][e]) * ((av[k][e] - mu) * inv);
          });
          warp_sum2(m1, m2);
          m1 *= INV_H, m2 *= INV_H;
          bf16* dhr = dh_out + (nb0 + gr) * H;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            bf16 o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float yhat = (av[k][e] - mu) * inv;
              const float dyh = dv[k][e] * gv[k][e];
              const float da = (dyh - m1 - yhat * m2) * inv;
              const float dh = da * (av[k][e] > 0.f ? 1.f : av[k][e] + 1.f);
              o[e] = __float2bfloat16(dh);
              pdb[k][e] += dh;
              pdg[k][e] += dv[k][e] * yhat;
              pdbe[k][e] += dv[k][e];
            }
            *dh_smem(col(k, 0)) = *reinterpret_cast<const uint2*>(o);
            *reinterpret_cast<uint2*>(dhr + col(k, 0)) = *reinterpret_cast<const uint2*>(o);
          }
        }
#pragma unroll
        for (int k = 0; k < KG; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = col(k, e);
            red[(warp * 3 + 0) * H + c] = pdb[k][e];
            red[(warp * 3 + 1) * H + c] = pdg[k][e];
            red[(warp * 3 + 2) * H + c] = pdbe[k][e];
          }
      }
      fence_async_smem();  // dh16 rows for the wgmma of both warpgroups
      consumers_sync();
      for (int c = tid; c < 3 * H; c += CONSUMERS) {  // warps summed in a fixed order
        const int q = c / H, col = c % H;
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < 8; ++wi) s += red[(wi * 3 + q) * H + col];
        pn[c] = s;
      }
      fence_async_smem();  // these generic accesses before the TMA writes that follow
      consumers_sync();
      if (elected) mbar_arrive(xempty);  // the region may take the first x chunk

      // ---- 2. dx_raw = dh16 @ w^T, 128 columns of Din at a time
      const float* g0n = g0 + (size_t)n * Din;
      const uint32_t abase = smem_u32(dhs) + wg * 64 * 128;
      const int ra = wg * 64 + wl * 16 + (lane >> 2);  // this thread's rows ra, ra + 8
      for (int dc = 0; dc < nchunks; ++dc) {
        const int d0 = dc * R3_NC;
        float2 g0r[2][8];  // g0 at this thread's columns, loaded before the product
        if (dx != nullptr) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i4 = 0; i4 < 8; ++i4)
              g0r[j][i4] = *reinterpret_cast<const float2*>(g0n + d0 + j * 64 + i4 * 8 + (lane & 3) * 2);
        }
        float acc[2][32];
        int prev = -1;
        for (int kt = 0; kt < H / R3_KD; ++kt) {
          ring.consumer_wait();
          const uint32_t b = smem_u32(ring.buf());
          wg_fence();
          // K-major, 128-byte swizzle: 8-row groups 1024 B apart, k16 steps 32 B
#pragma unroll
          for (int k = 0; k < R3_KD / 16; ++k)
            wgmma_k16<2, 0, 0>(acc, 2, make_desc_sw(abase + kt * R3_ATOM + k * 32, 16, 1024, 1),
                               make_desc_sw(b + k * 32, 16, 1024, 1), 0, (kt | k) != 0);
          wg_commit();
          wg_wait<1>();  // the step before is done: its stage may be refilled
          if (prev >= 0) release_stage(&empty[prev], elected);
          prev = ring.stage;
          ring.advance();
        }
        wg_wait<0>();
        fence_acc(acc);
        release_stage(&empty[prev], elected);

        mbar_wait(xfull, xfp);
        xfp ^= 1;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i4 = 0; i4 < 8; ++i4) {
            const int cl = j * 64 + i4 * 8 + (lane & 3) * 2;
            const float v00 = acc[j][i4 * 4], v01 = acc[j][i4 * 4 + 1];      // row ra
            const float v10 = acc[j][i4 * 4 + 2], v11 = acc[j][i4 * 4 + 3];  // row ra + 8
            const __nv_bfloat162 xa = x_pair(xb, ra, cl), xc = x_pair(xb, ra + 8, cl);
            float sg0 = v00 * __low2float(xa) + v10 * __low2float(xc);
            float sg1 = v01 * __high2float(xa) + v11 * __high2float(xc);
            float sb0 = v00 + v10, sb1 = v01 + v11;
            sg0 = col_warp_sum(sg0);
            sg1 = col_warp_sum(sg1);
            sb0 = col_warp_sum(sb0);
            sb1 = col_warp_sum(sb1);
            if (lane < 4) {
              cred[(warp * 2) * R3_NC + cl] = sg0;
              cred[(warp * 2) * R3_NC + cl + 1] = sg1;
              cred[(warp * 2 + 1) * R3_NC + cl] = sb0;
              cred[(warp * 2 + 1) * R3_NC + cl + 1] = sb1;
            }
            if (dx != nullptr) {
              const float ga = g0r[j][i4].x, gb = g0r[j][i4].y;
              const size_t base = ((size_t)n * B + row0) * Din + d0 + cl;
              if (row0 + ra < B)
                *reinterpret_cast<__nv_bfloat162*>(dx + base + (size_t)ra * Din) =
                    __floats2bfloat162_rn(v00 * ga, v01 * gb);
              if (row0 + ra + 8 < B)
                *reinterpret_cast<__nv_bfloat162*>(dx + base + (size_t)(ra + 8) * Din) =
                    __floats2bfloat162_rn(v10 * ga, v11 * gb);
            }
          }
        consumers_sync();
        {  // warps summed in a fixed order: dg0 (q 0), db0 (q 1)
          const int q = tid >> 7, c = tid & 127;
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < 8; ++wi) s += cred[(wi * 2 + q) * R3_NC + c];
          pn[3 * H + q * Din + d0 + c] = s;
        }
        fence_async_smem();  // the reads of x before the TMA writes of the next chunk
        consumers_sync();
        if (dc + 1 < nchunks && elected) mbar_arrive(xempty);
      }
    }
  }
}

bool dims_ok(int N, int B, int Din, int H) {
  return N > 0 && B > 0 && Din > 0 && Din % 128 == 0 && H % 128 == 0 && H >= 128 && H <= 512;
}

struct Scratch {
  size_t dh, part, dwp, tmp, total;
};

Scratch scratch_layout(int N, int B, int Din, int H) {
  const int nblk = (B + R3_ROWS - 1) / R3_ROWS, P = 3 * H + 2 * Din;
  Scratch s;
  s.dh = 0;
  s.part = align256((size_t)N * B * H * 2);
  s.dwp = s.part + align256((size_t)nblk * N * P * 4);
  s.tmp = s.dwp + dw_partial_bytes(N, B, Din, H);
  s.total = s.tmp + colsum_tmp_bytes(N, nblk, P);
  return s;
}

template <int HK>
int launch_fwd(int N, int B, int Din, long long sx, const void* x, const void* w,
               const void* b, const void* g, const void* be, const void* g0, const void* b0,
               void* y, void* a, cudaStream_t st) {
  constexpr int H = 128 * HK;
  static int max_clusters = 0;
  const int xa = sx == 0 ? 1 : N;
  FwdMaps maps;
  memset(&maps, 0, sizeof maps);
  int err = make_map(&maps.x, x, Din, B, xa, (uint64_t)Din * 2, (uint64_t)B * Din * 2, FK, BM,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = make_map(&maps.w[0], w, H, Din, N, (uint64_t)H * 2, (uint64_t)Din * H * 2, 64, FK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&maps.y, y, H, B, N, (uint64_t)H * 2, (uint64_t)B * H * 2, 64, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&maps.a, a, H, B, N, (uint64_t)H * 2, (uint64_t)B * H * 2, 64, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  Layers p = {};
  p.b[0] = (const float*)b;
  p.g[0] = (const float*)g;
  p.be[0] = (const float*)be;
  return launch_fwd_clusters(dense_fwd_wgmma_kernel<HK>, FwdSmem<HK>::TOTAL, &max_clusters, N, B,
                             st, maps, N, B, Din, xa, (const float*)g0, (const float*)b0, p);
}

template <int HK>
int launch_rows(int N, int B, int Din, long long sx, const void* dy, const void* a,
                const void* x, const void* w, const void* g, const void* g0, void* dx, void* dh,
                void* part, cudaStream_t st) {
  constexpr int H = 128 * HK;
  const size_t smem = rows_layout(H).total;
  const int xa = sx == 0 ? 1 : N;
  CUtensorMap wmap, xmap;
  int err = make_map(&wmap, w, H, Din, N, (uint64_t)H * 2, (uint64_t)Din * H * 2, R3_KD, R3_NC,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&xmap, x, Din, B, xa, (uint64_t)Din * 2, (uint64_t)B * Din * 2, 64, R3_ROWS,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = allow_smem(ln_bwd_rows_wgmma_kernel<HK>, smem);
  if (err != 0) return err;
  const int nblk = (B + R3_ROWS - 1) / R3_ROWS;
  const int items = N * nblk, grid = items < sm_count() ? items : sm_count();
  ln_bwd_rows_wgmma_kernel<HK><<<grid, RP_THREADS, smem, st>>>(
      wmap, xmap, N, B, Din, xa, nblk, (const bf16*)dy, (const bf16*)a, (const float*)g,
      (const float*)g0, (bf16*)dx, (bf16*)dh, (float*)part);
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points launch on `stream`, allocate nothing and return the
// first launch error (cudaErrorInvalidValue for shapes they do not take).

extern "C" int dense_elu_ln_fwd(int N, int B, int Din, int H, long long sx, const void* x,
                                const void* w, const void* b, const void* g, const void* be,
                                const void* g0, const void* b0, void* y, void* a, void* stream) {
  if (!dims_ok(N, B, Din, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (H / 128) {
    case 1: return launch_fwd<1>(N, B, Din, sx, x, w, b, g, be, g0, b0, y, a, st);
    case 2: return launch_fwd<2>(N, B, Din, sx, x, w, b, g, be, g0, b0, y, a, st);
    case 3: return launch_fwd<3>(N, B, Din, sx, x, w, b, g, be, g0, b0, y, a, st);
    default: return launch_fwd<4>(N, B, Din, sx, x, w, b, g, be, g0, b0, y, a, st);
  }
}

// Blocks of a forward cluster: each W tile of B2 (and B4) is read from L2
// once per cluster and work item of this many 64-row blocks.
extern "C" int mlp_fwd_cluster_blocks() { return FWD_CL; }

// Bytes of device scratch dense_elu_ln_bwd needs: dh16 [N,B,H] bf16, the
// row pass's partial sums, the dW pass's partial tiles when it splits its
// rows, and the first level of the sums' reduction.
extern "C" long long dense_elu_ln_bwd_scratch(int N, int B, int Din, int H) {
  if (!dims_ok(N, B, Din, H)) return 0;
  return (long long)scratch_layout(N, B, Din, H).total;
}

// vec_h [3][N][H] f32 (db, dgamma, dbeta); vec_d [2][N][Din] f32 (dg0, db0);
// dx [N,B,Din] bf16 or null.
extern "C" int dense_elu_ln_bwd(int N, int B, int Din, int H, long long sx, const void* dy,
                                const void* a, const void* x, const void* w, const void* g,
                                const void* g0, const void* b0, void* dx, void* dw, void* vec_h,
                                void* vec_d, void* scratch, void* stream) {
  if (!dims_ok(N, B, Din, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch lay = scratch_layout(N, B, Din, H);
  unsigned char* base = (unsigned char*)scratch;
  void* dh = base + lay.dh;
  float* part = (float*)(base + lay.part);
  int err;
  switch (H / 128) {
    case 1: err = launch_rows<1>(N, B, Din, sx, dy, a, x, w, g, g0, dx, dh, part, st); break;
    case 2: err = launch_rows<2>(N, B, Din, sx, dy, a, x, w, g, g0, dx, dh, part, st); break;
    case 3: err = launch_rows<3>(N, B, Din, sx, dy, a, x, w, g, g0, dx, dh, part, st); break;
    default: err = launch_rows<4>(N, B, Din, sx, dy, a, x, w, g, g0, dx, dh, part, st); break;
  }
  if (err != 0) return err;
  err = launch_dw<true>(N, B, Din, H, sx, (const bf16*)x, (const float*)g0, (const float*)b0,
                        (const bf16*)dh, (float*)dw, (float*)(base + lay.dwp), st);
  if (err != 0) return err;
  const int nblk = (B + R3_ROWS - 1) / R3_ROWS;
  return launch_colsum(N, nblk, 3 * H + 2 * Din, 3 * H, H, Din, part, (float*)(base + lay.tmp),
                       (float*)vec_h, (float*)vec_d, st);
}
