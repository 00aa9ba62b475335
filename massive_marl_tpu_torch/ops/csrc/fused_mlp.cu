// Fused Dense -> ELU -> LayerNorm block, forward (B2) and backward (B3), for
// agent-stacked operands (CUDA C++ for sm_90a, bf16 tensor cores via wmma).
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
// Design.  The TPU kernel walks the row blocks of one agent in order and
// accumulates the column sums and dW in place across grid steps.  Blocks run
// in no order here, so the backward pass is three launches with no atomics,
// and its results are the same from run to run:
//   1. a row pass: each block owns BM = 64 whole rows, recomputes the
//      LayerNorm statistics, writes dh16 to a scratch buffer, computes dx on
//      the tensor cores, and writes one partial column sum per block for
//      db, dgamma, dbeta, dg0 and db0;
//   2. a dW pass: each block owns one [64 x 128] tile of dW and loops over
//      the rows (xt is formed as it is loaded); when there are too few tiles
//      to fill the card, the rows are split into S ranges whose partial tiles
//      are summed in the third step;
//   3. a fixed-order reduction of the partials.
// The forward block also owns BM whole rows, so the LayerNorm statistics
// stay on chip: the product is staged through shared memory in K tiles of 32
// and the bias/ELU/LayerNorm epilogue reads the f32 tile back from shared
// memory (64 x 512 f32 = 128 KB at H = 512).
//
// What bounds it on this card: at the main path's shapes (B = 32,768 rows,
// Din and H up to 512) a layer moves ~2 bytes per multiply-add of its
// product, far below the ~295 operations per byte at which the tensor cores
// and not device memory would bound it: both kernels are bound by bytes.
// This first version keeps every intermediate of a row block on chip and
// reads each operand once per block, but it does not overlap loads with the
// products (no cp.async/TMA pipeline, no wgmma): that is a later PR's work.

#include "fused_mlp_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B2: forward
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(int B, int Din, long long sx, const bf16* __restrict__ x,
           const bf16* __restrict__ w, const float* __restrict__ bias,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           const float* __restrict__ g0, const float* __restrict__ b0,
           bf16* __restrict__ y, bf16* __restrict__ a) {
  constexpr int H = 128 * HK;
  constexpr int LDA = KT + 8, LDB = H + 8, LDC = H + 4;
  constexpr int FN = H / 4 / 16;  // accumulator fragments across a warp's columns
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [BM][LDA] xt tile
  bf16* Bs = As + BM * LDA;                  // [KT][LDB] w tile
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC] after the product

  const int n = blockIdx.y, row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;
  const bf16* xn = x + n * sx;
  const bf16* wn = w + (size_t)n * Din * H;
  const float* g0n = g0 + (size_t)n * Din;
  const float* b0n = b0 + (size_t)n * Din;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < Din; k0 += KT) {
    {  // xt tile: 64 rows x 32 columns, 8 values per thread
      const int r = tid >> 2, c = (tid & 3) * 8;
      const int gr = row0 + r;
      *reinterpret_cast<uint4*>(As + r * LDA + c) =
          load_xt8(xn + (size_t)(gr < B ? gr : 0) * Din, g0n, b0n, k0 + c, gr < B);
    }
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
        wmma::load_matrix_sync(af[i], As + (wr * 32 + i * 16) * LDA + kk, LDA);
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
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * (H / 4) + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: one warp per row, H / 32 columns per lane
  const float* bn = bias + (size_t)n * H;
  const float* gn = gamma + (size_t)n * H;
  const float* ben = beta + (size_t)n * H;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr, gr = row0 + r;
    if (gr >= B) break;
    float v[H / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < H / 32; ++j) {
      const int c = lane + 32 * j;
      const float h = Cs[r * LDC + c] + bn[c];
      v[j] = h > 0.f ? h : expf(h) - 1.f;
      s += v[j];
    }
    const float mu = warp_sum(s) / H;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < H / 32; ++j) {
      const float d = v[j] - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / H + EPS);
    bf16* yr = y + ((size_t)n * B + gr) * H;
    bf16* ar = a + ((size_t)n * B + gr) * H;
#pragma unroll
    for (int j = 0; j < H / 32; ++j) {
      const int c = lane + 32 * j;
      yr[c] = __float2bfloat16((v[j] - mu) * inv * gn[c] + ben[c]);
      ar[c] = __float2bfloat16(v[j]);
    }
  }
}

template <int HK>
size_t fwd_smem() {
  constexpr int H = 128 * HK;
  const size_t tiles = (size_t)BM * (KT + 8) * 2 + (size_t)KT * (H + 8) * 2;
  const size_t c = (size_t)BM * (H + 4) * 4;
  return tiles > c ? tiles : c;
}

// ---------------------------------------------------------------------------
// B3: backward, pass 1 (rows)
// ---------------------------------------------------------------------------

template <int HK>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(int B, int Din, long long sx, const bf16* __restrict__ dy,
                const bf16* __restrict__ a, const bf16* __restrict__ x,
                const bf16* __restrict__ w, const float* __restrict__ gamma,
                const float* __restrict__ g0, bf16* __restrict__ dx,
                bf16* __restrict__ dh_out, float* __restrict__ part) {
  constexpr int H = 128 * HK;
  constexpr int LDH = H + 8, LDW = KT + 8, LDC = DC + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dhs = reinterpret_cast<bf16*>(smem);                     // [BM][LDH]
  unsigned char* rest = smem + (size_t)BM * LDH * 2;
  float* red = reinterpret_cast<float*>(rest);                   // [8][3][H], phase 1
  bf16* Ws = reinterpret_cast<bf16*>(rest);                      // [DC][LDW], phase 2
  float* Cs = reinterpret_cast<float*>(rest + (size_t)DC * LDW * 2);  // [BM][LDC]

  const int n = blockIdx.y, blk = blockIdx.x, row0 = blk * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = 3 * H + 2 * Din;
  float* pn = part + ((size_t)n * gridDim.x + blk) * P;
  const float* gn = gamma + (size_t)n * H;

  // ---- phase 1: LayerNorm and ELU backward, one warp per row
  {
    float pdb[H / 32], pdg[H / 32], pdbe[H / 32];
#pragma unroll
    for (int j = 0; j < H / 32; ++j) pdb[j] = pdg[j] = pdbe[j] = 0.f;
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr, gr = row0 + r;
      if (gr >= B) {
#pragma unroll
        for (int j = 0; j < H / 32; ++j) dhs[r * LDH + lane + 32 * j] = __float2bfloat16(0.f);
        continue;
      }
      const bf16* ar = a + ((size_t)n * B + gr) * H;
      const bf16* dyr = dy + ((size_t)n * B + gr) * H;
      float av[H / 32], dv[H / 32];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        av[j] = __bfloat162float(ar[lane + 32 * j]);
        dv[j] = __bfloat162float(dyr[lane + 32 * j]);
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
      bf16* dhr = dh_out + ((size_t)n * B + gr) * H;
#pragma unroll
      for (int j = 0; j < H / 32; ++j) {
        const int c = lane + 32 * j;
        const float yhat = (av[j] - mu) * inv;
        const float dyh = dv[j] * gn[c];
        const float da = (dyh - m1 - yhat * m2) * inv;
        const float dh = da * (av[j] > 0.f ? 1.f : av[j] + 1.f);
        const bf16 dh16 = __float2bfloat16(dh);
        dhs[r * LDH + c] = dh16;
        dhr[c] = dh16;
        pdb[j] += dh;
        pdg[j] += dv[j] * yhat;
        pdbe[j] += dv[j];
      }
    }
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
    pn[c] = s;
  }
  __syncthreads();

  // ---- phase 2: dx_raw = dh16 @ w^T, DC columns of Din at a time
  const int wr = warp >> 2, wc = warp & 3;
  const bf16* wn = w + (size_t)n * Din * H;
  const float* g0n = g0 + (size_t)n * Din;
  const bf16* xn = x + n * sx;
  for (int d0 = 0; d0 < Din; d0 += DC) {
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
          wmma::load_matrix_sync(af[i], dhs + (wr * 32 + i * 16) * LDH + k0 + kk, LDH);
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
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
    if (dx != nullptr) {
      for (int idx = tid; idx < BM * DC; idx += THREADS) {
        const int r = idx / DC, c = idx % DC, gr = row0 + r;
        if (gr < B)
          dx[((size_t)n * B + gr) * Din + d0 + c] = __float2bfloat16(Cs[r * LDC + c] * g0n[d0 + c]);
      }
    }
    if (tid < DC) {  // column sums over the block's rows, in row order
      const int c = tid;
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < BM && row0 + r < B; ++r) {
        const float v = Cs[r * LDC + c];
        sg += v * __bfloat162float(xn[(size_t)(row0 + r) * Din + d0 + c]);
        sb += v;
      }
      pn[3 * H + d0 + c] = sg;
      pn[3 * H + Din + d0 + c] = sb;
    }
    __syncthreads();
  }
}

template <int HK>
size_t rows_smem() {
  constexpr int H = 128 * HK;
  const size_t dh = (size_t)BM * (H + 8) * 2;
  const size_t red = (size_t)8 * 3 * H * 4;
  const size_t gemm = (size_t)DC * (KT + 8) * 2 + (size_t)BM * (DC + 4) * 4;
  return dh + (red > gemm ? red : gemm);
}

// ---------------------------------------------------------------------------
// B3: backward, pass 2 (dW tiles, fused_mlp_common.cuh) and pass 3
// (fixed-order reductions)
// ---------------------------------------------------------------------------

// Sums the row pass's per-block partials [N][nblk][3H + 2Din] in block order.
__global__ void reduce_vec_kernel(int N, int nblk, int H, int Din, const float* __restrict__ part,
                                  float* db, float* dg, float* dbe, float* dg0, float* db0) {
  const int P = 3 * H + 2 * Din;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * P) return;
  const int n = idx / P, c = idx % P;
  const float* p = part + (size_t)n * nblk * P + c;
  float s = 0.f;
#pragma unroll 16
  for (int b = 0; b < nblk; ++b) s += p[(size_t)b * P];
  if (c < H) db[n * H + c] = s;
  else if (c < 2 * H) dg[n * H + c - H] = s;
  else if (c < 3 * H) dbe[n * H + c - 2 * H] = s;
  else if (c < 3 * H + Din) dg0[n * Din + c - 3 * H] = s;
  else db0[n * Din + c - 3 * H - Din] = s;
}

struct Scratch {
  size_t dh, part, dwp, total;
};

Scratch scratch_layout(int N, int B, int Din, int H) {
  const size_t nblk = (B + BM - 1) / BM;
  Scratch s;
  s.dh = 0;
  s.part = align256((size_t)N * B * H * 2);
  s.dwp = s.part + align256(nblk * N * (3 * H + 2 * Din) * 4);
  s.total = s.dwp + dw_partial_bytes(N, B, Din, H);
  return s;
}

template <int HK>
int launch_fwd(int N, int B, int Din, long long sx, const void* x, const void* w,
               const void* b, const void* g, const void* be, const void* g0, const void* b0,
               void* y, void* a, cudaStream_t st) {
  const size_t smem = fwd_smem<HK>();
  const int err = allow_smem(fwd_kernel<HK>, smem);
  if (err != 0) return err;
  dim3 grid((B + BM - 1) / BM, N);
  fwd_kernel<HK><<<grid, THREADS, smem, st>>>(
      B, Din, sx, (const bf16*)x, (const bf16*)w, (const float*)b, (const float*)g,
      (const float*)be, (const float*)g0, (const float*)b0, (bf16*)y, (bf16*)a);
  return (int)cudaGetLastError();
}

template <int HK>
int launch_rows(int N, int B, int Din, long long sx, const void* dy, const void* a,
                const void* x, const void* w, const void* g, const void* g0, void* dx, void* dh,
                void* part, cudaStream_t st) {
  const size_t smem = rows_smem<HK>();
  const int err = allow_smem(bwd_rows_kernel<HK>, smem);
  if (err != 0) return err;
  dim3 grid((B + BM - 1) / BM, N);
  bwd_rows_kernel<HK><<<grid, THREADS, smem, st>>>(
      B, Din, sx, (const bf16*)dy, (const bf16*)a, (const bf16*)x, (const bf16*)w,
      (const float*)g, (const float*)g0, (bf16*)dx, (bf16*)dh, (float*)part);
  return (int)cudaGetLastError();
}

bool dims_ok(int N, int B, int Din, int H) {
  return N > 0 && B > 0 && Din > 0 && Din % 128 == 0 && H % 128 == 0 && H >= 128 && H <= 512;
}

}  // namespace

// All entry points launch on `stream`, allocate nothing and return
// cudaGetLastError() (cudaErrorInvalidValue for shapes they do not take).

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

// Bytes of device scratch dense_elu_ln_bwd needs: dh16 [N,B,H] bf16, the
// row pass's partial sums and, when the dW pass splits its rows, the
// partial dW tiles.
extern "C" long long dense_elu_ln_bwd_scratch(int N, int B, int Din, int H) {
  if (!dims_ok(N, B, Din, H)) return 0;
  return (long long)scratch_layout(N, B, Din, H).total;
}

extern "C" int dense_elu_ln_bwd(int N, int B, int Din, int H, long long sx, const void* dy,
                                const void* a, const void* x, const void* w, const void* g,
                                const void* g0, const void* b0, void* dx, void* dw, void* db,
                                void* dg, void* dbe, void* dg0, void* db0, void* scratch,
                                void* stream) {
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

  const int nblk = (B + BM - 1) / BM;
  const int nvec = N * (3 * H + 2 * Din);
  reduce_vec_kernel<<<(nvec + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      N, nblk, H, Din, part, (float*)db, (float*)dg, (float*)dbe, (float*)dg0, (float*)db0);
  return (int)cudaGetLastError();
}
