// The whole MLPBase tower, forward (B4) and backward (B5), for agent-stacked
// operands (CUDA C++ for sm_90a, bf16 tensor cores via wmma).
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
// Design.  The TPU kernel keeps every layer of a 512-row block in VMEM and
// carries its sums across the in-order grid.  A Hopper block has 227 KB of
// shared memory and blocks run in no order, so:
//   * B4: a block owns BM = 64 whole rows through all layers.  Its current
//     layer input (bf16, 64 KB at width 512) stays in shared memory as the
//     product's A operand; W is staged in K tiles of 32 rows into a region
//     that, after the product, holds the f32 tile (128 KB at H = 512) for the
//     bias/ELU/LayerNorm epilogue, which writes the next layer's input in
//     place.  Nothing but the last y leaves the block: no residuals.
//   * B5: a row pass (tower_bwd_rows_kernel) runs that forward for its 64
//     rows, writing each layer's input x_l (l >= 1) and a_l to a scratch
//     buffer, then the whole backward chain with dy held in shared memory as
//     f32.  It overwrites a_l with dh16_l in place and writes one partial
//     column sum per block for every db, dgamma, dbeta, dg0 and db0.  Then
//     B3's dW pass (fused_mlp_common.cuh) runs once per layer on x_l and
//     dh16_l, and fixed-order reductions sum the partials: no atomics, the
//     same bits every run.  The scratch lives only for the backward call.
//
// What bounds it on this card: the tower moves only x, the weights and y (B5
// also dy and the gradients), and its L products do ~750 (B4) and ~2,100
// (B5, with the forward it recomputes) operations per byte that must move
// at the main path's critic tower (B = 32,768, Din = H = 512, L = 3), above
// the ~295 operations per byte at which the tensor cores and not device
// memory bound a kernel: both are bound by operations.  This first version
// reaches nowhere near that: wmma from shared memory with no cp.async/TMA
// pipeline and no wgmma, one 64-row block per SM (198-209 KB of shared
// memory), and B5's scratch sends x_l, a_l and dh16_l through device memory
// and re-reads them in the dW pass; that is a later PR's work.

#include "fused_mlp_common.cuh"

namespace {

constexpr int MAXL = 8;  // layers a tower may have

struct Layers {
  const bf16* w[MAXL];
  const float* b[MAXL];
  const float* g[MAXL];
  const float* be[MAXL];
};

__host__ __device__ inline size_t round128(size_t n) { return (n + 127) & ~size_t(127); }

// Shared memory of a block, D = max(Din, H):
//   R1  W K-tiles, then the f32 product tile [BM][H + 4]; in B5 also dy
//       [BM][D + 4] f32 and the warps' partial sums [8][3][H];
//   R2  the layer input [BM][D + 8] bf16; in B5 also dh16;
//   R3  (B5) W^T tiles [DC][KT + 8] bf16 for the dx product.
struct Regions {
  size_t r1, r2, r3;
  __host__ __device__ Regions(int Din, int H, bool bwd) {
    const size_t D = Din > H ? Din : H;
    size_t a = (size_t)BM * (H + 4) * 4, b = (size_t)KT * (H + 8) * 2;
    r1 = a > b ? a : b;
    if (bwd) {
      a = (size_t)BM * (D + 4) * 4;
      b = (size_t)8 * 3 * H * 4;
      r1 = r1 > a ? r1 : a;
      r1 = r1 > b ? r1 : b;
    }
    r1 = round128(r1);
    r2 = round128((size_t)BM * (D + 8) * 2);
    r3 = bwd ? round128((size_t)DC * (KT + 8) * 2) : 0;
  }
  __host__ __device__ size_t total() const { return r1 + r2 + r3; }
};

// The forward of all L layers for the block's BM rows.  Rows past B are
// computed from zero inputs and never stored.  B4 passes y and no scratch;
// B5 passes the scratch (ad: a_l at l*NBH; xs: x_{l+1} at l*NBH)
// and no y, and its last layer stops after a.
template <int HK>
__device__ void tower_forward(int B, int Din, int L, long long sx, const bf16* __restrict__ x,
                              const float* __restrict__ g0, const float* __restrict__ b0,
                              const Layers& p, unsigned char* R1, bf16* Xs, int LDX,
                              bf16* __restrict__ y, bf16* __restrict__ ad,
                              bf16* __restrict__ xs) {
  constexpr int H = 128 * HK;
  constexpr int LDB = H + 8, LDC = H + 4;
  constexpr int FN = H / 4 / 16;  // accumulator fragments across a warp's columns
  bf16* Bs = reinterpret_cast<bf16*>(R1);    // [KT][LDB] w tile
  float* Cs = reinterpret_cast<float*>(R1);  // [BM][LDC] after the product
  const int n = blockIdx.y, N = gridDim.y, row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const size_t NBH = (size_t)N * B * H;

  {  // layer 0's input: xt = bf16(x*g0 + b0), 8 values per thread and step
    const bf16* xn = x + n * sx;
    const float* g0n = g0 + (size_t)n * Din;
    const float* b0n = b0 + (size_t)n * Din;
    for (int idx = tid; idx < BM * Din / 8; idx += THREADS) {
      const int r = idx / (Din / 8), c = (idx % (Din / 8)) * 8, gr = row0 + r;
      *reinterpret_cast<uint4*>(Xs + r * LDX + c) =
          load_xt8(xn + (size_t)(gr < B ? gr : 0) * Din, g0n, b0n, c, gr < B);
    }
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int K = l == 0 ? Din : H;
    const bf16* wn = p.w[l] + (size_t)n * K * H;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += KT) {
      for (int idx = tid; idx < KT * H / 8; idx += THREADS) {
        const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const uint4*>(wn + (size_t)(k0 + r) * H + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], Xs + (wr * 32 + i * 16) * LDX + k0 + kk, LDX);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, Bs + kk * LDB + wc * (H / 4) + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * (H / 4) + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    // epilogue: one warp per row, H / 32 columns per lane
    const bool last = l == L - 1;
    const float* bn = p.b[l] + (size_t)n * H;
    const float* gn = p.g[l] + (size_t)n * H;
    const float* ben = p.be[l] + (size_t)n * H;
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr, gr = row0 + r;
      const bool valid = gr < B;
      const size_t orow = ((size_t)n * B + gr) * H;
      float v[H / 32];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        const int c = lane + 32 * j;
        const float h = Cs[r * LDC + c] + bn[c];
        v[j] = h > 0.f ? h : expf(h) - 1.f;
        s += v[j];
      }
      if (ad != nullptr && valid) {
#pragma unroll
        for (int j = 0; j < H / 32; ++j)
          ad[l * NBH + orow + lane + 32 * j] = __float2bfloat16(v[j]);
      }
      if (last && y == nullptr) continue;  // B5 needs no LayerNorm output of the last layer
      const float mu = warp_sum(s) / H;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        const float d = v[j] - mu;
        q += d * d;
      }
      const float inv = rsqrtf(warp_sum(q) / H + EPS);
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        const int c = lane + 32 * j;
        const bf16 yv = __float2bfloat16((v[j] - mu) * inv * gn[c] + ben[c]);
        if (!last) {
          Xs[r * LDX + c] = yv;
          if (xs != nullptr && valid) xs[l * NBH + orow + c] = yv;
        } else if (valid) {
          y[orow + c] = yv;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B4
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(THREADS)
tower_fwd_kernel(int B, int Din, int L, long long sx, const bf16* __restrict__ x,
                 const float* __restrict__ g0, const float* __restrict__ b0, Layers p,
                 bf16* __restrict__ y) {
  constexpr int H = 128 * HK;
  extern __shared__ __align__(128) unsigned char smem[];
  const Regions reg(Din, H, false);
  const int LDX = (Din > H ? Din : H) + 8;
  tower_forward<HK>(B, Din, L, sx, x, g0, b0, p, smem, reinterpret_cast<bf16*>(smem + reg.r1),
                    LDX, y, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// B5: the row pass (forward recompute and the backward chain)
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(THREADS)
tower_bwd_rows_kernel(int B, int Din, int L, long long sx, const bf16* __restrict__ dy,
                      const bf16* __restrict__ x, const float* __restrict__ g0,
                      const float* __restrict__ b0, Layers p, bf16* __restrict__ dx,
                      bf16* __restrict__ ad, bf16* __restrict__ xs, float* __restrict__ part) {
  constexpr int H = 128 * HK;
  constexpr int LDW = KT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Regions reg(Din, H, true);
  const int D = Din > H ? Din : H;
  const int LDX = D + 8, LDY = D + 4;
  float* dys = reinterpret_cast<float*>(smem);                       // [BM][LDY] dy (f32)
  float* red = dys;                                                  // [8][3][H] partials
  bf16* Xs = reinterpret_cast<bf16*>(smem + reg.r1);                 // [BM][LDX] input, dh16
  bf16* Ws = reinterpret_cast<bf16*>(smem + reg.r1 + reg.r2);        // [DC][LDW] w^T tile
  const int n = blockIdx.y, N = gridDim.y, blk = blockIdx.x, row0 = blk * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const size_t NBH = (size_t)N * B * H;
  const int P = 3 * L * H + 2 * Din;
  float* pn = part + ((size_t)n * gridDim.x + blk) * P;

  tower_forward<HK>(B, Din, L, sx, x, g0, b0, p, smem, Xs, LDX, nullptr, ad, xs);

  for (int idx = tid; idx < BM * H; idx += THREADS) {  // the last layer's dy, f32
    const int r = idx / H, c = idx % H, gr = row0 + r;
    dys[r * LDY + c] = gr < B ? __bfloat162float(dy[((size_t)n * B + gr) * H + c]) : 0.f;
  }
  __syncthreads();

  for (int l = L - 1; l >= 0; --l) {
    bf16* adl = ad + l * NBH + (size_t)n * B * H;  // a_l, overwritten by dh16_l
    const float* gn = p.g[l] + (size_t)n * H;

    // ---- phase 1: LayerNorm and ELU backward, one warp per row
    {
      float pdb[H / 32], pdg[H / 32], pdbe[H / 32];
#pragma unroll
      for (int j = 0; j < H / 32; ++j) pdb[j] = pdg[j] = pdbe[j] = 0.f;
      for (int rr = 0; rr < BM / 8; ++rr) {
        const int r = warp * (BM / 8) + rr, gr = row0 + r;
        if (gr >= B) {
#pragma unroll
          for (int j = 0; j < H / 32; ++j) Xs[r * LDX + lane + 32 * j] = __float2bfloat16(0.f);
          continue;
        }
        bf16* ar = adl + (size_t)gr * H;
        float av[H / 32], dv[H / 32];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < H / 32; ++j) {
          av[j] = __bfloat162float(ar[lane + 32 * j]);
          dv[j] = dys[r * LDY + lane + 32 * j];
          s += av[j];
        }
        const float mu = warp_sum(s) / H;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < H / 32; ++j) {
          const float d = av[j] - mu;
          q += d * d;
        }
        const float inv = rsqrtf(warp_sum(q) / H + EPS);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < H / 32; ++j) {
          const float yhat = (av[j] - mu) * inv;
          const float dyh = dv[j] * gn[lane + 32 * j];
          s1 += dyh;
          s2 += dyh * yhat;
        }
        const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
#pragma unroll
        for (int j = 0; j < H / 32; ++j) {
          const int c = lane + 32 * j;
          const float yhat = (av[j] - mu) * inv;
          const float dyh = dv[j] * gn[c];
          const float da = (dyh - m1 - yhat * m2) * inv;
          const float dh = da * (av[j] > 0.f ? 1.f : av[j] + 1.f);
          const bf16 dh16 = __float2bfloat16(dh);
          Xs[r * LDX + c] = dh16;
          ar[c] = dh16;
          pdb[j] += dh;
          pdg[j] += dv[j] * yhat;
          pdbe[j] += dv[j];
        }
      }
      __syncthreads();  // dy is consumed: its region takes the warps' partials
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        const int c = lane + 32 * j;
        red[(warp * 3 + 0) * H + c] = pdb[j];
        red[(warp * 3 + 1) * H + c] = pdg[j];
        red[(warp * 3 + 2) * H + c] = pdbe[j];
      }
    }
    __syncthreads();
    for (int c = tid; c < 3 * H; c += THREADS) {  // warps summed in a fixed order
      const int q = c / H, col = c % H;
      float s = 0.f;
      for (int wi = 0; wi < 8; ++wi) s += red[(wi * 3 + q) * H + col];
      pn[3 * H * l + c] = s;
    }
    __syncthreads();

    // ---- phase 2: the next dy (or layer 0's dx_raw) = dh16 @ w_l^T, f32,
    // DC columns at a time, into the dy region
    const int Dl = l == 0 ? Din : H;
    const bf16* wn = p.w[l] + (size_t)n * Dl * H;
    for (int d0 = 0; d0 < Dl; d0 += DC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
      for (int k0 = 0; k0 < H; k0 += KT) {
        for (int idx = tid; idx < DC * KT / 8; idx += THREADS) {  // Ws[j][k] = w[d0+j][k0+k]
          const int j = idx / (KT / 8), k = (idx % (KT / 8)) * 8;
          *reinterpret_cast<uint4*>(Ws + j * LDW + k) =
              *reinterpret_cast<const uint4*>(wn + (size_t)(d0 + j) * H + k0 + k);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(af[i], Xs + (wr * 32 + i * 16) * LDX + k0 + kk, LDX);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
            wmma::load_matrix_sync(bfr, Ws + (wc * 32 + j * 16) * LDW + kk, LDW);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(dys + (wr * 32 + i * 16) * LDY + d0 + wc * 32 + j * 16,
                                  acc[i][j], LDY, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // layer 0: dg0 = sum dx_raw * x and db0 = sum dx_raw over the block's rows
  // in row order; dx = bf16(dx_raw * g0) when asked for
  const bf16* xn = x + n * sx;
  const float* g0n = g0 + (size_t)n * Din;
  for (int c = tid; c < Din; c += THREADS) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < BM && row0 + r < B; ++r) {
      const float v = dys[r * LDY + c];
      sg += v * __bfloat162float(xn[(size_t)(row0 + r) * Din + c]);
      sb += v;
    }
    pn[3 * L * H + c] = sg;
    pn[3 * L * H + Din + c] = sb;
  }
  if (dx != nullptr) {
    for (int idx = tid; idx < BM * Din; idx += THREADS) {
      const int r = idx / Din, c = idx % Din, gr = row0 + r;
      if (gr < B) dx[((size_t)n * B + gr) * Din + c] = __float2bfloat16(dys[r * LDY + c] * g0n[c]);
    }
  }
}

// Sums the row pass's per-block partials [N][nblk][3LH + 2Din] in block
// order into vh [3L][N][H] (db, dgamma, dbeta of each layer) and vd
// [2][N][Din] (dg0, db0).
__global__ void tower_reduce_vec_kernel(int N, int nblk, int H, int Din, int L,
                                        const float* __restrict__ part, float* __restrict__ vh,
                                        float* __restrict__ vd) {
  const int P = 3 * L * H + 2 * Din;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * P) return;
  const int n = idx / P, c = idx % P;
  const float* pp = part + (size_t)n * nblk * P + c;
  float s = 0.f;
#pragma unroll 16
  for (int b = 0; b < nblk; ++b) s += pp[(size_t)b * P];
  if (c < 3 * L * H) {
    vh[((size_t)(c / H) * N + n) * H + c % H] = s;
  } else {
    const int d = c - 3 * L * H;
    vd[((size_t)(d / Din) * N + n) * Din + d % Din] = s;
  }
}

struct Scratch {
  size_t ad, xs, part, dwp, total;
};

Scratch scratch_layout(int N, int B, int Din, int H, int L) {
  const size_t nbh2 = (size_t)N * B * H * 2;
  const size_t nblk = (B + BM - 1) / BM;
  size_t dwp = dw_partial_bytes(N, B, Din, H);
  const size_t dwp_h = dw_partial_bytes(N, B, H, H);
  if (L > 1 && dwp_h > dwp) dwp = dwp_h;
  Scratch s;
  s.ad = 0;
  s.xs = align256(L * nbh2);
  s.part = s.xs + align256((L - 1) * nbh2);
  s.dwp = s.part + align256(nblk * N * (3 * L * H + 2 * Din) * 4);
  s.total = s.dwp + dwp;
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
  const size_t smem = Regions(Din, 128 * HK, false).total();
  const int err = allow_smem(tower_fwd_kernel<HK>, smem);
  if (err != 0) return err;
  dim3 grid((B + BM - 1) / BM, N);
  tower_fwd_kernel<HK><<<grid, THREADS, smem, st>>>(B, Din, L, sx, (const bf16*)x,
                                                    (const float*)g0, (const float*)b0, p,
                                                    (bf16*)y);
  return (int)cudaGetLastError();
}

template <int HK>
int launch_tower_rows(int N, int B, int Din, int L, long long sx, const void* dy, const void* x,
                      const void* g0, const void* b0, const Layers& p, void* dx, bf16* ad,
                      bf16* xs, float* part, cudaStream_t st) {
  const size_t smem = Regions(Din, 128 * HK, true).total();
  const int err = allow_smem(tower_bwd_rows_kernel<HK>, smem);
  if (err != 0) return err;
  dim3 grid((B + BM - 1) / BM, N);
  tower_bwd_rows_kernel<HK><<<grid, THREADS, smem, st>>>(
      B, Din, L, sx, (const bf16*)dy, (const bf16*)x, (const float*)g0, (const float*)b0, p,
      (bf16*)dx, ad, xs, part);
  return (int)cudaGetLastError();
}

// Din up to 512 keeps B5's block within the card's shared memory at every H.
bool tower_dims_ok(int N, int B, int Din, int H, int L) {
  return N > 0 && B > 0 && L > 0 && L <= MAXL && Din > 0 && Din % 128 == 0 && Din <= 512 &&
         H % 128 == 0 && H >= 128 && H <= 512;
}

}  // namespace

// All entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() or the error of a refused launch
// (cudaErrorInvalidValue for shapes they do not take).  Per-layer operands
// come as host arrays of L device pointers.

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
// x_l [L-1][N,B,H] bf16, the row pass's partial sums and the dW pass's
// partial tiles.
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
  const int nvec = N * (3 * L * H + 2 * Din);
  tower_reduce_vec_kernel<<<(nvec + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      N, nblk, H, Din, L, part, (float*)vec_h, (float*)vec_d);
  return (int)cudaGetLastError();
}
