// Pieces shared by the fused MLP kernels of fused_mlp.cu (B2/B3) and
// fused_tower.cu (B4/B5): block constants, a warp sum, the bf16 input
// affine, and the backward's dW pass and its fixed-order reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr float EPS = 1e-6f;  // flax.linen.LayerNorm default epsilon
constexpr int BM = 64;        // rows per block in the row passes
constexpr int KT = 32;        // depth of a staged K tile
constexpr int THREADS = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int DC = 128;       // dx columns per chunk in the backward row pass
constexpr int TD = 64;        // dW tile rows (Din)
constexpr int TH = 128;       // dW tile columns (H)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt in to

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// Loads 8 consecutive bf16 of x, applies the input affine in f32 and rounds
// back to bf16 (xt), or gives zeros for a row past the end.
__device__ __forceinline__ uint4 load_xt8(const bf16* xrow, const float* g0, const float* b0,
                                          int k, bool valid) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (valid) {
    uint4 raw = *reinterpret_cast<const uint4*>(xrow + k);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __float2bfloat16(__bfloat162float(v[j]) * g0[k + j] + b0[k + j]);
  }
  return out;
}

// dW = xt^T @ dh16 over the rows [split * rows_per_split, +rows_per_split):
// each block owns one [TD x TH] tile of one agent's dW.  With AFFINE, xt =
// bf16(x * g0 + b0) is formed as x is loaded; without it x is xt already
// (g0, b0 unused).  S > 1 splits write partial tiles [S][N][Din][H].
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
bwd_dw_kernel(int N, int B, int Din, int H, long long sx, int rows_per_split,
              const bf16* __restrict__ x, const float* __restrict__ g0,
              const float* __restrict__ b0, const bf16* __restrict__ dh,
              float* __restrict__ out) {
  constexpr int LDX = TD + 8, LDD = TH + 8;
  __shared__ __align__(128) bf16 Xs[KT * LDX];  // [row][din]: xt^T read as col-major A
  __shared__ __align__(128) bf16 Ds[KT * LDD];  // [row][h]
  const int n = blockIdx.y, split = blockIdx.z;
  const int tiles_h = H / TH;
  const int d0 = (blockIdx.x / tiles_h) * TD, h0 = (blockIdx.x % tiles_h) * TH;
  const int rbeg = split * rows_per_split;
  const int rend = min(B, rbeg + rows_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, wr = warp >> 2, wc = warp & 3;
  const bf16* xn = x + n * sx;
  const bf16* dhn = dh + (size_t)n * B * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int r0 = rbeg; r0 < rend; r0 += KT) {
    {  // xt rows: 32 x 64, 8 per thread
      const int r = tid >> 3, c = (tid & 7) * 8, gr = r0 + r;
      const bf16* xrow = xn + (size_t)(gr < rend ? gr : 0) * Din;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (AFFINE)
        v = load_xt8(xrow, g0 + (size_t)n * Din, b0 + (size_t)n * Din, d0 + c, gr < rend);
      else if (gr < rend)
        v = *reinterpret_cast<const uint4*>(xrow + d0 + c);
      *reinterpret_cast<uint4*>(Xs + r * LDX + c) = v;
    }
    for (int idx = tid; idx < KT * TH / 8; idx += THREADS) {
      const int r = idx / (TH / 8), c = (idx % (TH / 8)) * 8, gr = r0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < rend) v = *reinterpret_cast<const uint4*>(dhn + (size_t)gr * H + h0 + c);
      *reinterpret_cast<uint4*>(Ds + r * LDD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], Xs + kk * LDX + wr * 32 + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Ds + kk * LDD + wc * 32 + j * 16, LDD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* on = out + ((size_t)split * N + n) * Din * H;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(on + (size_t)(d0 + wr * 32 + i * 16) * H + h0 + wc * 32 + j * 16,
                              acc[i][j], H, wmma::mem_row_major);
}

// Sums the dW pass's S partial tiles [S][N*Din*H] in split order.
__global__ void reduce_dw_kernel(long long total, int S, const float* __restrict__ part,
                                 float* __restrict__ dw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[k * total + i];
  dw[i] = s;
}

// Row splits of the dW pass: enough blocks for two per SM, each split a
// multiple of KT rows.
void dw_split(int N, int B, int Din, int H, int* S, int* rows) {
  const int tiles = (Din / TD) * (H / TH) * N;
  int s = (2 * 132 + tiles - 1) / tiles;
  const int max_s = (B + 1023) / 1024;  // at least 1024 rows per split
  s = s < 1 ? 1 : (s > max_s ? max_s : s);
  s = s > 16 ? 16 : s;
  if (s < 1) s = 1;
  int r = (B + s - 1) / s;
  r = (r + KT - 1) / KT * KT;
  *S = (B + r - 1) / r;
  if (*S < 1) *S = 1;
  *rows = r;
}

// dW of one layer: the dW pass into `dw` (S == 1) or into the partial tiles
// at `dwp`, then their reduction.  Returns cudaGetLastError().
template <bool AFFINE>
int launch_dw(int N, int B, int Din, int H, long long sx, const bf16* x, const float* g0,
              const float* b0, const bf16* dh, float* dw, float* dwp, cudaStream_t st) {
  int S, rows;
  dw_split(N, B, Din, H, &S, &rows);
  dim3 grid((Din / TD) * (H / TH), N, S);
  bwd_dw_kernel<AFFINE><<<grid, THREADS, 0, st>>>(N, B, Din, H, sx, rows, x, g0, b0, dh,
                                                  S > 1 ? dwp : dw);
  int err = (int)cudaGetLastError();
  if (err != 0 || S == 1) return err;
  const long long total = (long long)N * Din * H;
  reduce_dw_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      total, S, dwp, dw);
  return (int)cudaGetLastError();
}

// Bytes of partial dW tiles launch_dw needs at `dwp` (0 when S == 1).
size_t dw_partial_bytes(int N, int B, int Din, int H) {
  int S, rows;
  dw_split(N, B, Din, H, &S, &rows);
  return S > 1 ? align256((size_t)S * N * Din * H * 4) : 0;
}

// Opts a kernel in to `bytes` of dynamic shared memory (needed above 48 KB)
// and refuses sizes the card cannot give a block.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
