// The whole MLPBase tower, forward (B4) and backward (B5), for agent-stacked
// operands: CUDA C++ for sm_90a, both on wgmma fed by TMA through mbarrier
// rings of shared-memory tiles.
//
// Replaces the TPU kernels massive_marl_tpu/ops/fused_mlp.py::
// _tower_fwd_kernel (B4) and ::_tower_bwd_kernel (B5).  The plain PyTorch
// versions with the same roundings are massive_marl_tpu_torch/ops/
// fused_mlp.py::tower_fwd_plain and ::tower_bwd_plain.
//
// Per agent n, L layers of width H (x [N,B,Din] bf16 with agent stride sx,
// 0 when every agent reads the same rows; w_l [N,Din_l,H] bf16, Din_0 = Din
// and Din_l = H after; vectors f32):
//   forward:  x_0 = bf16(x*g0 + b0); for each layer h = x_l @ w_l + b_l (f32
//             accumulation), a_l = h > 0 ? h : exp(h) - 1, y_l = LN(a_l) *
//             gamma_l + beta_l, x_{l+1} = bf16(y_l).  Hidden layers take no
//             input affine.  Only the last y is stored.
//   backward: the forward again, keeping a_l as bf16; then from the last
//             layer down, with dy f32 (the bf16 input for the last layer):
//             the LayerNorm statistics from bf16 a_l, dh = LN/ELU backward,
//             dh16 = bf16(dh), dW_l = x_l^T @ dh16, db_l = sum dh, dgamma_l =
//             sum dy*yhat, dbeta_l = sum dy, and the next dy = dh16 @ w_l^T in
//             f32, never rounded to bf16.  Layer 0's dx_raw = dh16 @ w_0^T
//             gives dg0 = sum dx_raw*x and db0 = sum dx_raw, and dx =
//             bf16(dx_raw*g0) when asked for.
//
// What bounds it on this card: the tower moves only x, the weights and y (B5
// also dy and the gradients), and its L products do ~750 (B4) and ~2,100
// (B5, with the forward it recomputes) operations per byte that must move
// at the main path's critic tower (B = 32,768, Din = H = 512, L = 3), above
// the ~295 operations per byte at which the tensor cores and not device
// memory bound a kernel: both are bound by operations.
//
// Design.  The TPU kernel keeps every layer of a 512-row block in VMEM and
// carries its sums across the in-order grid.  A Hopper block has 227 KB of
// shared memory and blocks run in no order, so:
//   * B4 (tower_fwd_wgmma_kernel) is fwd_body of fused_mlp_common.cuh, B2's
//     forward with L layers.  A persistent grid of 2-block clusters walks
//     work items of two 64-row blocks of one agent.  Layer 0 streams x
//     through the ring with W_0 (the input affine applied in place); its
//     epilogue, from the accumulators, writes x_1 into a resident
//     [64 rows][H] bf16 buffer, the A operand of the next layer, and so on.
//     Only the last y leaves, staged in that buffer, by TMA stores that run
//     on under the next item's layer-0 product.  Each W tile is read from
//     L2 once per cluster and multicast to both blocks, which halves the L2
//     traffic of W (805 -> 403 MB at the critic tower); the producer keeps
//     the ring full across layers and items.  The epilogues still run on
//     the warps that issue the products.
//   * B5: a row pass (tower_bwd_wgmma_kernel) owns 64 rows.  A producer
//     warp streams W_0 .. W_{L-1} and then W_{L-1}^T .. W_0^T by TMA
//     through a ring of four 32 KB tiles; two consumer warpgroups each
//     compute half the columns of every product on wgmma, the layer input
//     (x_l, then dh16_l) resident in shared memory as the A operand and
//     each product's f32 result held in the accumulators (64 x 512 f32 over
//     the two warpgroups is 128 registers a thread; setmaxnreg gives the
//     consumers 232).  Its forward products are fwd_product's, B2's and
//     B4's routine: the wgmmas of B5's own earlier product, in the same
//     order, after one change: the accumulators are zeroed and fenced
//     before the first wgmma (which still ignores them), so the values of
//     the epilogue before die after their last use.
//     Only per-row statistics cross between the warpgroups, through shared
//     memory: no f32 dy tile.  The forward writes x_l (l >= 1) and a_l to a
//     scratch buffer; the backward reads a_l back by TMA, overwrites it with
//     dh16_l, keeps dy f32 in the accumulators from one layer to the next,
//     and writes one partial column sum per block for every db, dgamma,
//     dbeta, dg0 and db0.  Then the dW pass (fused_mlp_common.cuh, shared
//     with B3) runs once per layer on x_l and dh16_l, and fixed-order
//     reductions sum the partials: no atomics, the same bits every run.  The
//     scratch lives only for the backward call.  What holds B5 back is the
//     work between its products: the epilogues run on the same warps as the
//     products with nothing to overlap them at one block per SM, and every
//     64-row block streams all of W (~3 MB at the critic tower) from L2.

#include "fused_mlp_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B4
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(RP_THREADS, 1)
tower_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, int N, int B, int Din, int L,
                       int x_agents, const float* __restrict__ g0, const float* __restrict__ b0,
                       const __grid_constant__ Layers p) {
  fwd_body<HK>(maps, N, B, Din, L, x_agents, false, g0, b0, p);
}

// ---------------------------------------------------------------------------
// B5: the row pass (forward recompute and the backward chain on wgmma)
// ---------------------------------------------------------------------------

constexpr int T5_KD = FK;     // depth of a W tile (fwd_product's stage depth)
constexpr int T5_STAGES = 4;
constexpr uint32_t T5_STAGE_BYTES = 32 * 512 * 2;  // a W tile: 32 x H (forward) or Din_l x 32
constexpr int T5_NB = 4;      // 64-column accumulator blocks per consumer warpgroup (256 columns)

// Shared memory of the row pass, D = max(Din, H):
//   act    the layer input x_l, then dh16_l: [64 rows][K] bf16, K-major with
//          the 128-byte swizzle in atoms of 64 columns (the A operand of
//          every product; K = Din or H);
//   ring   T5_STAGES W tiles, loaded by TMA: forward [32 k][H] MN-major in
//          64-column boxes (128-byte swizzle), backward [Din_l][32 k]
//          K-major in 128-row boxes (64-byte swizzle);
//   stats  per-row sums of the two warpgroups, two alternating buffers;
//   cred   the warps' column sums [8][3][256] f32;
//   vec    the current layer's bias, LayerNorm scale and bias, and gamma0
//          (at the start beta0 in the bias slot), [4][512] f32;
//   bars   full/empty per ring stage, and the barrier of a_l's TMA load.
struct TowerSmem {
  size_t ring, stats, cred, vec, bars, total;
};

__host__ __device__ inline TowerSmem tower_layout(int Din, int H) {
  const size_t D = Din > H ? Din : H;
  TowerSmem s;
  s.ring = align1k((size_t)BM * D * 2);
  s.stats = s.ring + (size_t)T5_STAGES * T5_STAGE_BYTES;
  s.cred = s.stats + 2 * 2 * 64 * 4;
  s.vec = s.cred + (size_t)8 * 3 * 256 * 4;
  s.bars = s.vec + 4 * 512 * 4;
  s.total = s.bars + (2 * T5_STAGES + 1) * 8;
  return s;
}

// The element (row, column) of a warpgroup accumulator block: register i of
// block j of a thread at quad row r (rows r and r + 8).
#define T5_COL(cb, j, i) ((cb) + (j) * 64 + ((i) >> 2) * 8 + (lane & 3) * 2 + ((i) & 1))

// A backward product of a 64-row block, run by both consumer warpgroups:
// acc = act[64 x K] @ W_l^T over K in ring tiles [width][T5_KD] (K-major,
// 64-byte swizzle), nb 64-column blocks per warpgroup; width is the full
// product width, the warpgroup's half starting at column wg * nb * 64.  The
// forward products are fwd_product's (fused_mlp_common.cuh).
__device__ __forceinline__ void tower_bwd_product(float (&acc)[T5_NB][32], int nb, uint32_t act,
                                                  int K, Ring& ring, int width, int wg,
                                                  bool elected) {
  int prev = -1;
  for (int ks = 0; ks < K / T5_KD; ++ks) {
    ring.consumer_wait();
    const uint32_t b = smem_u32(ring.buf());
    wg_fence();
#pragma unroll
    for (int k = 0; k < T5_KD / 16; ++k) {
      const int s = ks * 2 + k;  // k16 step: atom s / 4, 32 B per step inside it
      const uint64_t da = make_desc_sw(act + (s >> 2) * (BM * 128) + (s & 3) * 32, 16, 1024, 1);
      // rows of 64 B, 8-row groups 512 B apart, k16 steps 32 B
      wgmma_k16<T5_NB, 0, 0>(acc, nb, da,
                             make_desc_sw(b + wg * (width / 2) * 64 + k * 32, 16, 512, 2),
                             (64 * 64) >> 4, (ks | k) != 0);
    }
    wg_commit();
    wg_wait<1>();  // the step before is done: its stage may be refilled
    if (prev >= 0) release_stage(&ring.empty[prev], elected);
    prev = ring.stage;
    ring.advance();
  }
  wg_wait<0>();
  fence_acc(acc);
  release_stage(&ring.empty[prev], elected);
}

// The tensor maps of the W tiles, W_l as stored (forward) and as W_l^T
// (backward), one pair per layer; and of the a_l scratch [L * N][B][H],
// read back in 64 x 64 boxes.
struct TowerMaps {
  CUtensorMap fwd[MAXL], bwd[MAXL], act;
};

// A warp's column sum: v is the sum over the thread's two rows of column cw
// (of its warpgroup's columns); col_warp_sum adds the warp's 16 rows, then
// lanes 0-3 store it in cred [warp][q][256].
__device__ __forceinline__ void cred_store(float* cred, int warp, int q, int cw, float v) {
  v = col_warp_sum(v);
  if ((threadIdx.x & 31) < 4) cred[(warp * 3 + q) * 256 + cw] = v;
}

// The warpgroup's 4 warps summed in a fixed order into part[out + q * stride
// + cb + c] for q < nq, c < width.
__device__ __forceinline__ void cred_flush(const float* cred, int wg, int t, int nq, int width,
                                           float* out, int stride, int cb) {
  for (int c = t; c < nq * width; c += 128) {
    const int q = c / width, cc = c % width;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += cred[((wg * 4 + w) * 3 + q) * 256 + cc];
    out[q * stride + cb + cc] = s;
  }
}

template <int HK>
__global__ void __launch_bounds__(RP_THREADS, 1)
tower_bwd_wgmma_kernel(const __grid_constant__ TowerMaps maps, int B, int Din, int L,
                       long long sx, const bf16* __restrict__ dy,
                       const bf16* __restrict__ x, const float* __restrict__ g0,
                       const float* __restrict__ b0, Layers p, bf16* __restrict__ dx,
                       bf16* __restrict__ ad, bf16* __restrict__ xs, float* __restrict__ part) {
  constexpr int H = 128 * HK;
  constexpr int NBH = H / 128;  // 64-column blocks per warpgroup of an H-wide result
  constexpr int NT = H / 2;     // columns per warpgroup of an H-wide result
  constexpr float INV_H = 1.f / H;  // a mean is the sum times 1/H, as torch's mean computes it
  extern __shared__ __align__(1024) unsigned char smem[];
  const TowerSmem S = tower_layout(Din, H);
  unsigned char* act = smem;
  float* stats = reinterpret_cast<float*>(smem + S.stats);
  float* cred = reinterpret_cast<float*>(smem + S.cred);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S.bars);
  uint64_t* empty = full + T5_STAGES;
  uint64_t* abar = empty + T5_STAGES;
  float* vec = reinterpret_cast<float*>(smem + S.vec);
  const int n = blockIdx.y, N = gridDim.y, blk = blockIdx.x, row0 = blk * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    ring_init(full, empty, T5_STAGES);
    mbar_init(abar, 1);
  }
  mbar_init_fence();
  __syncthreads();
  Ring ring{full, empty, smem + S.ring, T5_STAGE_BYTES, T5_STAGES, 0, 0};

  if (warp >= 8) {  // ---- producer: W_0 .. W_{L-1} as stored, then W_{L-1}^T .. W_0^T
    regs_dealloc<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      for (int l = 0; l < L; ++l) {
        const int K = l == 0 ? Din : H;
        for (int k0 = 0; k0 < K; k0 += T5_KD) {
          ring.producer_acquire();
          uint64_t* bar = &full[ring.stage];
          mbar_expect_tx(bar, T5_KD * H * 2);
          for (int b = 0; b < H / 64; ++b)
            tma_load(ring.buf() + b * (T5_KD * 128), &maps.fwd[l], bar, 64 * b, k0, n);
          ring.advance();
        }
      }
      for (int l = L - 1; l >= 0; --l) {
        const int Nl = l == 0 ? Din : H;
        for (int k0 = 0; k0 < H; k0 += T5_KD) {
          ring.producer_acquire();
          uint64_t* bar = &full[ring.stage];
          mbar_expect_tx(bar, Nl * T5_KD * 2);
          for (int b = 0; b < Nl / 128; ++b)
            tma_load(ring.buf() + b * (128 * T5_KD * 2), &maps.bwd[l], bar, k0, 128 * b, n);
          ring.advance();
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    // ---- consumers: warpgroup wg computes the columns [wg * width / 2, ...) of
    // every product for all 64 rows; this thread holds rows ra and ra + 8
    const int wg = warp >> 2, t = tid & 127;
    const bool elected = t == 0;
    const int ra = (warp & 3) * 16 + (lane >> 2);
    const bool va = row0 + ra < B, vb = row0 + ra + 8 < B;
    const size_t NBHt = (size_t)N * B * H;
    const size_t rowa = (size_t)n * B + row0 + ra, rowb = rowa + 8;
    const int P = 3 * L * H + 2 * Din;
    float* pn = part + ((size_t)n * gridDim.x + blk) * P;
    const uint32_t act_u = smem_u32(act);
    int sb = 0;  // the stats buffer of the next row reduction
    auto rows_sum = [&](float& v0, float& v1) {
      row_allreduce2(v0, v1, stats + sb * 128, wg, ra);
      sb ^= 1;
    };

    // vectors are read from shared memory, staged once per layer: global
    // loads at scattered columns would each wait out their latency
    auto stage = [&](int slot, const float* src, int len) {
      for (int c = tid; c < len; c += CONSUMERS) vec[slot * 512 + c] = src[c];
    };
    stage(0, b0 + (size_t)n * Din, Din);
    stage(3, g0 + (size_t)n * Din, Din);
    consumers_sync();
    {  // layer 0's input: xt = bf16(x*g0 + b0)
      const bf16* xn = x + n * sx;
      for (int c = tid; c < 8 * Din; c += CONSUMERS) {  // chunk j of row r
        const int r = c / (Din / 8), j = c % (Din / 8), gr = row0 + r;
        *reinterpret_cast<uint4*>(act + (j >> 3) * (BM * 128) + r * 128 + (((j & 7) ^ (r & 7)) << 4)) =
            load_xt8(xn + (size_t)(gr < B ? gr : 0) * Din, vec + 3 * 512, vec, j * 8, gr < B);
      }
    }
    fence_async_smem();
    consumers_sync();

    float acc[T5_NB][32];
    const int cb = wg * NT;  // this warpgroup's first column of an H-wide result
    for (int l = 0; l < L; ++l) {
      const int K = l == 0 ? Din : H;
      stage(0, p.b[l] + (size_t)n * H, H);
      stage(1, p.g[l] + (size_t)n * H, H);
      stage(2, p.be[l] + (size_t)n * H, H);
      fwd_product<T5_NB, 1>(acc, NBH, act_u, K, ring, 0, 0, wg, elected, false);
      consumers_sync();
      const float* bn = vec;
      bf16* adl = ad + l * NBHt;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = T5_COL(cb, j, i);
          const float2 bb = *reinterpret_cast<const float2*>(bn + col);
          float h0 = acc[j][i] + bb.x, h1 = acc[j][i + 1] + bb.y;
          h0 = h0 > 0.f ? h0 : expf(h0) - 1.f;
          h1 = h1 > 0.f ? h1 : expf(h1) - 1.f;
          acc[j][i] = h0;
          acc[j][i + 1] = h1;
          const bool lower = (i & 2) != 0;
          if (lower) s1 += h0 + h1;
          else s0 += h0 + h1;
          if (lower ? vb : va)
            *reinterpret_cast<__nv_bfloat162*>(adl + (lower ? rowb : rowa) * H + col) =
                __floats2bfloat162_rn(h0, h1);
        }
      if (l == L - 1) break;  // the backward needs no LayerNorm output of the last layer
      rows_sum(s0, s1);
      const float mu0 = s0 * INV_H, mu1 = s1 * INV_H;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float d = acc[j][i] - ((i & 2) ? mu1 : mu0);
          if (i & 2) q1 += d * d;
          else q0 += d * d;
        }
      rows_sum(q0, q1);  // both warpgroups are past their products: act may take x_{l+1}
      const float inv0 = rsqrtf(q0 * INV_H + EPS), inv1 = rsqrtf(q1 * INV_H + EPS);
      const float* gn = vec + 512;
      const float* ben = vec + 1024;
      bf16* xsl = xs + l * NBHt;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = T5_COL(cb, j, i);
          const bool lower = (i & 2) != 0;
          const float mu = lower ? mu1 : mu0, inv = lower ? inv1 : inv0;
          const float2 gg = *reinterpret_cast<const float2*>(gn + col);
          const float2 bb = *reinterpret_cast<const float2*>(ben + col);
          const float y0 = (acc[j][i] - mu) * inv * gg.x + bb.x;
          const float y1 = (acc[j][i + 1] - mu) * inv * gg.y + bb.y;
          const __nv_bfloat162 yv = __floats2bfloat162_rn(y0, y1);
          *act_ptr(act, ra + (lower ? 8 : 0), col) = yv;
          if (lower ? vb : va)
            *reinterpret_cast<__nv_bfloat162*>(xsl + (lower ? rowb : rowa) * H + col) = yv;
        }
      fence_async_smem();
      consumers_sync();
    }

    // the last layer's dy (bf16 in), f32 in the accumulator layout; rows past
    // B load row B - 1 (all loads in flight together) and count as zeros
    const size_t rowa_c = (size_t)n * B + min(row0 + ra, B - 1);
    const size_t rowb_c = (size_t)n * B + min(row0 + ra + 8, B - 1);
#pragma unroll
    for (int j = 0; j < NBH; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = T5_COL(cb, j, i);
        const bool lower = (i & 2) != 0;
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dy + (lower ? rowb_c : rowa_c) * H + col));
        const bool ok = lower ? vb : va;
        acc[j][i] = ok ? v.x : 0.f;
        acc[j][i + 1] = ok ? v.y : 0.f;
      }
    // the forward's a_l stores before the TMA reads of them below
    asm volatile("fence.proxy.async;" ::: "memory");
    int ap = 0;  // phase of abar

    for (int l = L - 1; l >= 0; --l) {
      bf16* adl = ad + l * NBHt;  // a_l, overwritten by dh16_l
      stage(1, p.g[l] + (size_t)n * H, H);
      const float* gn = vec + 512;
      // a_l's 64 rows into act by TMA once both warpgroups are past their
      // last product (rows past B read as zeros); dh16_l then replaces it
      consumers_sync();
      if (tid == 0) {
        mbar_expect_tx(abar, BM * H * 2);
        for (int b = 0; b < H / 64; ++b)
          tma_load(act + b * (BM * 128), &maps.act, abar, 64 * b, row0, l * N + n);
      }
      mbar_wait(abar, ap);
      ap ^= 1;
      auto load_a = [&](int j, int i) {
        return __bfloat1622float2(*act_ptr(act, ra + ((i & 2) ? 8 : 0), T5_COL(cb, j, i)));
      };
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float2 av = load_a(j, i);
          if (i & 2) s1 += av.x + av.y;
          else s0 += av.x + av.y;
        }
      rows_sum(s0, s1);
      const float mu0 = s0 * INV_H, mu1 = s1 * INV_H;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float2 av = load_a(j, i);
          const float mu = (i & 2) ? mu1 : mu0;
          const float d0 = av.x - mu, d1 = av.y - mu;
          if (i & 2) q1 += d0 * d0 + d1 * d1;
          else q0 += d0 * d0 + d1 * d1;
        }
      rows_sum(q0, q1);
      const float inv0 = rsqrtf(q0 * INV_H + EPS), inv1 = rsqrtf(q1 * INV_H + EPS);
      float m10 = 0.f, m11 = 0.f, m20 = 0.f, m21 = 0.f;
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = T5_COL(cb, j, i);
          const float2 av = load_a(j, i);
          const float2 gg = *reinterpret_cast<const float2*>(gn + col);
          const bool lower = (i & 2) != 0;
          const float mu = lower ? mu1 : mu0, inv = lower ? inv1 : inv0;
          const float y0 = (av.x - mu) * inv, y1 = (av.y - mu) * inv;
          const float e0 = acc[j][i] * gg.x, e1 = acc[j][i + 1] * gg.y;
          if (lower) {
            m11 += e0 + e1;
            m21 += e0 * y0 + e1 * y1;
          } else {
            m10 += e0 + e1;
            m20 += e0 * y0 + e1 * y1;
          }
        }
      rows_sum(m10, m11);
      rows_sum(m20, m21);
      m10 *= INV_H, m11 *= INV_H, m20 *= INV_H, m21 *= INV_H;
      // column sums of db (q 0), dgamma = dy * yhat (1) and dbeta = dy (2); dh16
#pragma unroll
      for (int j = 0; j < NBH; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {  // columns col, col + 1 of rows ra (i, i + 1), ra + 8 (i + 2, i + 3)
          const int col = T5_COL(cb, j, i), cw = col - cb;
          const float2 aa = load_a(j, i), ab = load_a(j, i + 2);
          const float2 gg = *reinterpret_cast<const float2*>(gn + col);
          const float ya0 = (aa.x - mu0) * inv0, ya1 = (aa.y - mu0) * inv0;
          const float yb0 = (ab.x - mu1) * inv1, yb1 = (ab.y - mu1) * inv1;
          const float d00 = acc[j][i], d01 = acc[j][i + 1], d10 = acc[j][i + 2], d11 = acc[j][i + 3];
          const float h00 = ((d00 * gg.x - m10 - ya0 * m20) * inv0) * (aa.x > 0.f ? 1.f : aa.x + 1.f);
          const float h01 = ((d01 * gg.y - m10 - ya1 * m20) * inv0) * (aa.y > 0.f ? 1.f : aa.y + 1.f);
          const float h10 = ((d10 * gg.x - m11 - yb0 * m21) * inv1) * (ab.x > 0.f ? 1.f : ab.x + 1.f);
          const float h11 = ((d11 * gg.y - m11 - yb1 * m21) * inv1) * (ab.y > 0.f ? 1.f : ab.y + 1.f);
          cred_store(cred, warp, 0, cw, h00 + h10);
          cred_store(cred, warp, 0, cw + 1, h01 + h11);
          cred_store(cred, warp, 1, cw, d00 * ya0 + d10 * yb0);
          cred_store(cred, warp, 1, cw + 1, d01 * ya1 + d11 * yb1);
          cred_store(cred, warp, 2, cw, d00 + d10);
          cred_store(cred, warp, 2, cw + 1, d01 + d11);
          const __nv_bfloat162 ha = __floats2bfloat162_rn(h00, h01), hb = __floats2bfloat162_rn(h10, h11);
          *act_ptr(act, ra, col) = ha;
          *act_ptr(act, ra + 8, col) = hb;
          if (va) *reinterpret_cast<__nv_bfloat162*>(adl + rowa * H + col) = ha;
          if (vb) *reinterpret_cast<__nv_bfloat162*>(adl + rowb * H + col) = hb;
        }
      fence_async_smem();
      consumers_sync();
      cred_flush(cred, wg, t, 3, NT, pn + 3 * H * l, H, cb);  // db, dgamma, dbeta of layer l
      consumers_sync();

      // the next dy (or layer 0's dx_raw) = dh16 @ w_l^T, f32
      const int Nl = l == 0 ? Din : H;
      tower_bwd_product(acc, Nl / 128, act_u, H, ring, Nl, wg, elected);
    }

    // layer 0: dg0 = sum dx_raw * x, db0 = sum dx_raw; dx = bf16(dx_raw * g0)
    const int nbd = Din / 128, cbd = wg * (Din / 2);
    const bf16* xn = x + n * sx;
    const float* g0n = vec + 3 * 512;
#pragma unroll
    for (int j = 0; j < T5_NB; ++j) {
      if (j >= nbd) break;
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4) {
        const int i = i4 * 4, col = T5_COL(cbd, j, i);
        float2 xa = make_float2(0.f, 0.f), xb = make_float2(0.f, 0.f);
        const size_t ga = min(row0 + ra, B - 1), gb = min(row0 + ra + 8, B - 1);
        xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xn + ga * Din + col));
        xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xn + gb * Din + col));
        if (!va) xa = make_float2(0.f, 0.f);
        if (!vb) xb = make_float2(0.f, 0.f);
        const float v00 = acc[j][i], v01 = acc[j][i + 1], v10 = acc[j][i + 2], v11 = acc[j][i + 3];
        cred_store(cred, warp, 0, col - cbd, v00 * xa.x + v10 * xb.x);  // dg0
        cred_store(cred, warp, 0, col - cbd + 1, v01 * xa.y + v11 * xb.y);
        cred_store(cred, warp, 1, col - cbd, v00 + v10);
        cred_store(cred, warp, 1, col - cbd + 1, v01 + v11);
        if (dx != nullptr) {
          const float2 gg = *reinterpret_cast<const float2*>(g0n + col);
          if (va)
            *reinterpret_cast<__nv_bfloat162*>(dx + rowa * Din + col) =
                __floats2bfloat162_rn(v00 * gg.x, v01 * gg.y);
          if (vb)
            *reinterpret_cast<__nv_bfloat162*>(dx + rowb * Din + col) =
                __floats2bfloat162_rn(v10 * gg.x, v11 * gg.y);
        }
      }
    }
    consumers_sync();
    cred_flush(cred, wg, t, 2, Din / 2, pn + 3 * L * H, Din, cbd);  // dg0, db0
  }
}

struct Scratch {
  size_t ad, xs, part, dwp, tmp, total;
};

Scratch scratch_layout(int N, int B, int Din, int H, int L) {
  const size_t nbh2 = (size_t)N * B * H * 2;
  const int nblk = (B + BM - 1) / BM, P = 3 * L * H + 2 * Din;
  size_t dwp = dw_partial_bytes(N, B, Din, H);
  const size_t dwp_h = dw_partial_bytes(N, B, H, H);
  if (L > 1 && dwp_h > dwp) dwp = dwp_h;
  Scratch s;
  s.ad = 0;
  s.xs = align256(L * nbh2);
  s.part = s.xs + align256((L - 1) * nbh2);
  s.dwp = s.part + align256((size_t)nblk * N * P * 4);
  s.tmp = s.dwp + dwp;
  s.total = s.tmp + colsum_tmp_bytes(N, nblk, P);
  return s;
}

Layers make_layers(int L, const void* const* w, const void* const* b, const void* const* g,
                   const void* const* be) {
  Layers p = {};
  for (int l = 0; l < L; ++l) {
    p.w[l] = (const bf16*)w[l];
    p.b[l] = (const float*)b[l];
    p.g[l] = (const float*)g[l];
    p.be[l] = (const float*)be[l];
  }
  return p;
}

template <int HK>
int launch_tower_fwd(int N, int B, int Din, int L, long long sx, const void* x, const void* g0,
                     const void* b0, const Layers& p, void* y, cudaStream_t st) {
  constexpr int H = 128 * HK;
  static int max_clusters = 0;
  const int xa = sx == 0 ? 1 : N;
  FwdMaps maps;
  memset(&maps, 0, sizeof maps);
  int err = make_map(&maps.x, x, Din, B, xa, (uint64_t)Din * 2, (uint64_t)B * Din * 2, FK, BM,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  for (int l = 0; l < L && err == 0; ++l) {
    const int K = l == 0 ? Din : H;
    err = make_map(&maps.w[l], p.w[l], H, K, N, (uint64_t)H * 2, (uint64_t)K * H * 2, 64, FK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == 0)
    err = make_map(&maps.y, y, H, B, N, (uint64_t)H * 2, (uint64_t)B * H * 2, 64, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  return launch_fwd_clusters(tower_fwd_wgmma_kernel<HK>, FwdSmem<HK>::TOTAL, &max_clusters, N, B,
                             st, maps, N, B, Din, L, xa, (const float*)g0, (const float*)b0, p);
}

template <int HK>
int launch_tower_rows(int N, int B, int Din, int L, long long sx, const void* dy, const void* x,
                      const void* g0, const void* b0, const Layers& p, void* dx, bf16* ad,
                      bf16* xs, float* part, cudaStream_t st) {
  constexpr int H = 128 * HK;
  const size_t smem = tower_layout(Din, H).total;
  TowerMaps maps;
  int err = 0;
  for (int l = 0; l < L && err == 0; ++l) {
    const int K = l == 0 ? Din : H;
    err = make_map(&maps.fwd[l], p.w[l], H, K, N, (uint64_t)H * 2, (uint64_t)K * H * 2, 64, T5_KD,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = make_map(&maps.bwd[l], p.w[l], H, K, N, (uint64_t)H * 2, (uint64_t)K * H * 2, T5_KD,
                     128, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == 0)
    err = make_map(&maps.act, ad, H, B, (uint64_t)L * N, (uint64_t)H * 2, (uint64_t)B * H * 2, 64,
                   BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = allow_smem(tower_bwd_wgmma_kernel<HK>, smem);
  if (err != 0) return err;
  dim3 grid((B + BM - 1) / BM, N);
  tower_bwd_wgmma_kernel<HK><<<grid, RP_THREADS, smem, st>>>(
      maps, B, Din, L, sx, (const bf16*)dy, (const bf16*)x, (const float*)g0, (const float*)b0, p,
      (bf16*)dx, ad, xs, part);
  return (int)cudaGetLastError();
}

// Din up to 512 keeps the blocks within the card's shared memory at every H.
bool tower_dims_ok(int N, int B, int Din, int H, int L) {
  return N > 0 && B > 0 && L > 0 && L <= MAXL && Din > 0 && Din % 128 == 0 && Din <= 512 &&
         H % 128 == 0 && H >= 128 && H <= 512;
}

}  // namespace

// All entry points launch on `stream`, allocate nothing and return the
// first launch error (cudaErrorInvalidValue for shapes they do not take).
// Per-layer operands come as host arrays of L device pointers.

extern "C" int mlp_tower_fwd(int N, int B, int Din, int H, int L, long long sx, const void* x,
                             const void* g0, const void* b0, const void* const* w,
                             const void* const* b, const void* const* g, const void* const* be,
                             void* y, void* stream) {
  if (!tower_dims_ok(N, B, Din, H, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layers p = make_layers(L, w, b, g, be);
  switch (H / 128) {
    case 1: return launch_tower_fwd<1>(N, B, Din, L, sx, x, g0, b0, p, y, st);
    case 2: return launch_tower_fwd<2>(N, B, Din, L, sx, x, g0, b0, p, y, st);
    case 3: return launch_tower_fwd<3>(N, B, Din, L, sx, x, g0, b0, p, y, st);
    default: return launch_tower_fwd<4>(N, B, Din, L, sx, x, g0, b0, p, y, st);
  }
}

// Bytes of device scratch mlp_tower_bwd needs: a_l/dh16_l [L][N,B,H] and
// x_l [L-1][N,B,H] bf16, the row pass's partial sums, the dW pass's partial
// tiles and the first level of the sums' reduction.
extern "C" long long mlp_tower_bwd_scratch(int N, int B, int Din, int H, int L) {
  if (!tower_dims_ok(N, B, Din, H, L)) return 0;
  return (long long)scratch_layout(N, B, Din, H, L).total;
}

// dw: L device pointers to [N, Din_l, H] f32; vec_h [3L][N][H] f32 (db,
// dgamma, dbeta of layer 0, then layer 1, ...); vec_d [2][N][Din] f32 (dg0,
// db0); dx [N,B,Din] bf16 or null.
extern "C" int mlp_tower_bwd(int N, int B, int Din, int H, int L, long long sx, const void* dy,
                             const void* x, const void* g0, const void* b0, const void* const* w,
                             const void* const* b, const void* const* g, const void* const* be,
                             void* dx, void* const* dw, void* vec_h, void* vec_d, void* scratch,
                             void* stream) {
  if (!tower_dims_ok(N, B, Din, H, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layers p = make_layers(L, w, b, g, be);
  const Scratch lay = scratch_layout(N, B, Din, H, L);
  unsigned char* base = (unsigned char*)scratch;
  bf16* ad = (bf16*)(base + lay.ad);
  bf16* xs = (bf16*)(base + lay.xs);
  float* part = (float*)(base + lay.part);
  float* dwp = (float*)(base + lay.dwp);
  int err;
  switch (H / 128) {
    case 1: err = launch_tower_rows<1>(N, B, Din, L, sx, dy, x, g0, b0, p, dx, ad, xs, part, st); break;
    case 2: err = launch_tower_rows<2>(N, B, Din, L, sx, dy, x, g0, b0, p, dx, ad, xs, part, st); break;
    case 3: err = launch_tower_rows<3>(N, B, Din, L, sx, dy, x, g0, b0, p, dx, ad, xs, part, st); break;
    default: err = launch_tower_rows<4>(N, B, Din, L, sx, dy, x, g0, b0, p, dx, ad, xs, part, st); break;
  }
  if (err != 0) return err;

  const size_t NBH = (size_t)N * B * H;
  for (int l = 0; l < L; ++l) {
    if (l == 0)
      err = launch_dw<true>(N, B, Din, H, sx, (const bf16*)x, (const float*)g0, (const float*)b0,
                            ad, (float*)dw[0], dwp, st);
    else
      err = launch_dw<false>(N, B, H, H, (long long)B * H, xs + (l - 1) * NBH, nullptr, nullptr,
                             ad + l * NBH, (float*)dw[l], dwp, st);
    if (err != 0) return err;
  }
  const int nblk = (B + BM - 1) / BM;
  return launch_colsum(N, nblk, 3 * L * H + 2 * Din, 3 * L * H, H, Din, part,
                       (float*)(base + lay.tmp), (float*)vec_h, (float*)vec_d, st);
}
