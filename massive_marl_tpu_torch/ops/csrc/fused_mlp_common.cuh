// Pieces shared by the fused MLP kernels of fused_mlp.cu (B2/B3) and
// fused_tower.cu (B4/B5): block constants, a warp sum, the bf16 input
// affine, the Hopper building blocks of the backward kernels (mbarriers, a
// ring of TMA-filled stages, wgmma on shared-memory descriptors), the
// backward's dW pass and the fixed-order reductions of partial sums.
//
// Shared-memory operand layouts.  Every wgmma operand of the backward
// kernels is a swizzled tile as TMA writes it: rows of 128 bytes (64 bf16)
// in atoms of 8 rows (1024 B), 16-byte chunk j of row r stored at chunk
// j ^ (r % 8) (the 64-byte swizzle: rows of 64 B, chunk j ^ ((r / 2) % 4)).
//   * K-major (K contiguous, as A = [M][K] row-major): a tile is
//     [rows][64 k] per atom column; the descriptor's stride byte offset is
//     the 1024 B between 8-row groups and a k16 step adds 32 B to the start;
//   * MN-major (M or N contiguous, as xt = [rows][Din] read as xt^T): a
//     tile is [k rows][64 m] per box; 8-row k groups are 1024 B apart (the
//     stride byte offset), 64-column boxes one box apart (the leading byte
//     offset), and a k16 step adds 2048 B.
// A tile written by the threads themselves (B3's dh16, B5's layer input)
// uses the same swizzle, so wgmma reads both kinds alike.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;  // wmma, in the forward kernels B2/B4
typedef __nv_bfloat16 bf16;

constexpr float EPS = 1e-6f;  // flax.linen.LayerNorm default epsilon
constexpr int BM = 64;        // rows per block in B2/B4 and per warpgroup product
constexpr int KT = 32;        // depth of a staged K tile in B2/B4
constexpr int THREADS = 256;  // B2/B4: 8 warps, 2 along rows x 4 along columns
constexpr int WS_THREADS = 288;   // the dW pass: two consumer warpgroups + a producer warp
constexpr int CONSUMERS = 256;    // threads of the two consumer warpgroups
// B3's and B5's row passes: two consumer warpgroups + a producer warpgroup
// that hands its registers to them (setmaxnreg: 128 x 40 + 256 x 232 of the
// SM's 65,536)
constexpr int RP_THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt in to

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }
__host__ __device__ inline size_t align1k(size_t n) { return (n + 1023) & ~size_t(1023); }

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

// ---------------------------------------------------------------------------
// PTX building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra WAIT_DONE;\n"
      "bra WAIT_LOOP;\n"
      "WAIT_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operand reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier over the two consumer warpgroups only (barrier 0 is
// __syncthreads, which the producer warp never reaches after the split).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, each stored in 16-byte units, and the swizzle mode of the layout
// field: 1 for 128-byte, 2 for 64-byte swizzled atoms (8 rows of 128 or 64
// bytes, 16-byte chunk j of row r stored at chunk j ^ (r % 8) or
// j ^ ((r / 2) % 4); atoms 1024-byte aligned).
__device__ __forceinline__ uint64_t make_desc_sw(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                                 int layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// ---- TMA: tensor maps (host) and tile loads (device)

// cuTensorMapEncodeTiled's signature; the driver function is looked up
// through the runtime, so the libraries link no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of a bf16 array d0 x d1 x d2 (d0 contiguous; s1, s2 the byte
// strides of dims 1 and 2) read in boxes b0 x b1 x 1.  Elements outside the
// array read as zeros.  Returns 0 or a CUDA error code.
int make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
             uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1}, estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Box (c0, c1, c2) of `map` into shared memory at dst; completes bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Arrives on bar and adds `bytes` to the transfer count its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Register budgets of a warp-specialized block: every warp of a warpgroup
// runs these together, in one branch per role that never rejoins the other.
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma
// fence, commit or wait.  Only where no wgmma on these registers is in
// flight (before the first, after wait_group 0): anywhere else ptxas sees the
// registers redefined and serializes the wgmma pipeline.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_OUT8(d, o)                                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),            \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_OUT32(d) WG_OUT8(d, 0), WG_OUT8(d, 8), WG_OUT8(d, 16), WG_OUT8(d, 24)

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], bf16 in, f32 accumulate.  TA / TB:
// 1 when that operand is MN-major.  Accumulator element i of a thread of
// warp w (in its warpgroup) and lane l sits at row w*16 + l/4 + 8*((i/2)%2),
// column (i/4)*8 + (l%4)*2 + i%2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same over 128 columns: d0 holds columns 0-63 and d1 columns 64-127,
// each laid out as wgmma_n64's accumulator.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d0)[32], float (&d1)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : WG_OUT32(d0), WG_OUT32(d1)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// One k16 step of a warpgroup's product over nb 64-column blocks of acc
// (nb <= NB, the same in every thread of the warpgroup): pairs of blocks
// take one n128 instruction, a last odd block an n64.  db64 is the
// descriptor offset (in 16-byte units) from one 64-column block of B to the
// next.
template <int NB, int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&acc)[NB][32], int nb, uint64_t da, uint64_t db,
                                          uint32_t db64, int scale_d) {
#pragma unroll
  for (int p = 0; p < NB; p += 2) {
    if (p + 1 < NB && p + 1 < nb) {
      wgmma_n128<TA, TB>(acc[p], acc[p + 1 < NB ? p + 1 : p], da, db + (uint64_t)p * db64,
                         scale_d);
    } else if (p < nb) {
      wgmma_n64<TA, TB>(acc[p], da, db + (uint64_t)p * db64, scale_d);
    }
  }
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
}

// A ring of shared-memory stages between one producer thread and the two
// consumer warpgroups: full[s] completes when the TMA loads of stage s have
// landed (the producer's expect_tx arrival plus their bytes); empty[s]
// when both consumer warpgroups are done with the stage.  stage/phase walk
// the ring in the same order on both sides.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;
  uint32_t stage_bytes;
  int stages, stage, phase;

  __device__ unsigned char* buf() const { return base + (size_t)stage * stage_bytes; }
  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // producer: wait until the current stage is free
  __device__ void producer_acquire() { mbar_wait(&empty[stage], phase ^ 1); }
  // consumer: wait until the current stage has landed
  __device__ void consumer_wait() {
    mbar_wait(&full[stage], phase);
    fence_async_smem();
  }
};

// Sets up a ring's barriers (one thread) before the role split: full[s]
// waits for the producer's expect_tx arrival, empty[s] for one arrival per
// consumer warpgroup.
__device__ inline void ring_init(uint64_t* full, uint64_t* empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 2);
  }
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Consumer side of one stage: after the warpgroup's wgmma group on the
// stage before has finished (wait_group 1 once the current group is
// committed), one thread of the warpgroup frees that earlier stage.
__device__ __forceinline__ void release_stage(uint64_t* empty, bool elected) {
  if (elected) mbar_arrive(empty);
}

// Row reduction across the two consumer warpgroups: each thread holds
// partial sums v0 (row r) and v1 (row r + 8) over its columns; lanes of a
// quad share rows.  Returns the full-row sums in a fixed order (quad lanes
// by xor shuffles, then warpgroup 0's half plus warpgroup 1's).  buf:
// [2 warpgroups][64 rows] f32, alternated between consecutive calls by the
// caller so one barrier per call suffices.
__device__ __forceinline__ void row_allreduce2(float& v0, float& v1, float* buf, int wg,
                                               int row) {
  v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
  v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
  if ((threadIdx.x & 3) == 0) {
    buf[wg * 64 + row] = v0;
    buf[wg * 64 + row + 8] = v1;
  }
  consumers_sync();
  v0 = buf[row] + buf[64 + row];
  v1 = buf[row + 8] + buf[64 + row + 8];
}

// Sum over the 8 row groups of a warp (lanes with the same l % 4) of a
// per-thread column value; every lane gets the warp's sum.
__device__ __forceinline__ float col_warp_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Opts a kernel in to `bytes` of dynamic shared memory (needed above 48 KB)
// and refuses sizes the card cannot give a block.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---------------------------------------------------------------------------
// The dW pass, shared by B3 and B5
// ---------------------------------------------------------------------------

constexpr int DW_TM = 128;    // dW tile rows (Din), 64 per consumer warpgroup
constexpr int DW_TN = 128;    // dW tile columns (H)
constexpr int DW_KR = 64;     // rows of x and dh per ring stage
constexpr int DW_STAGES = 6;
constexpr uint32_t DW_BOX = 64 * DW_KR * 2;       // one TMA box: 64 columns x DW_KR rows, 8 KB
constexpr uint32_t DW_STAGE_BYTES = 4 * DW_BOX;   // x: 2 boxes, dh: 2 boxes

__host__ __device__ inline size_t dw_smem() {
  return (size_t)DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8;
}

// dW = xt^T @ dh16 over rows [split * rows_per_split, + rows_per_split) for
// one [128 x 128] tile of one agent's dW.  The producer warp streams x and
// dh in 64-row steps by TMA (four 64 x 64 boxes, 128-byte swizzle: the
// operands are MN-major, rows of the batch being K; rows past B read as
// zeros).  With AFFINE, each consumer warpgroup forms xt = bf16(x * g0 + b0)
// in place in its half of the x tile before its wgmma reads it; without it x
// is xt already (g0, b0 unused).  S > 1 splits write partial tiles
// [S][N][Din][H], summed by reduce_dw_kernel in split order.
template <bool AFFINE>
__global__ void __launch_bounds__(WS_THREADS, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dmap,
                int N, int B, int Din, int H, int x_agents, int rows_per_split,
                const float* __restrict__ g0, const float* __restrict__ b0,
                float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  const int n = blockIdx.y, split = blockIdx.z;
  const int tiles_h = H / DW_TN;
  const int d0 = (blockIdx.x / tiles_h) * DW_TM, h0 = (blockIdx.x % tiles_h) * DW_TN;
  const int rbeg = split * rows_per_split;
  const int rend = min(B, rbeg + rows_per_split);
  const int steps = (rend - rbeg + DW_KR - 1) / DW_KR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) ring_init(full, empty, DW_STAGES);
  mbar_init_fence();
  __syncthreads();
  Ring ring{full, empty, smem, DW_STAGE_BYTES, DW_STAGES, 0, 0};

  if (warp == 8) {  // ---- producer: x and dh rows of each step, by TMA
    if (lane == 0) {
      const int nx = x_agents > 1 ? n : 0;
      for (int s = 0; s < steps; ++s) {
        ring.producer_acquire();
        unsigned char* buf = ring.buf();
        uint64_t* bar = &full[ring.stage];
        const int r0 = rbeg + s * DW_KR;
        mbar_expect_tx(bar, DW_STAGE_BYTES);
        tma_load(buf, &xmap, bar, d0, r0, nx);
        tma_load(buf + DW_BOX, &xmap, bar, d0 + 64, r0, nx);
        tma_load(buf + 2 * DW_BOX, &dmap, bar, h0, r0, n);
        tma_load(buf + 3 * DW_BOX, &dmap, bar, h0 + 64, r0, n);
        ring.advance();
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns dW rows d0 + 64 wg ... (x box wg)
  const int wg = warp >> 2, t = tid & 127;
  const bool elected = t == 0;
  // AFFINE: this thread converts physical chunk t % 8 of rows t / 8 + 16 i of
  // its warpgroup's x box, which holds columns d0 + 64 wg + 8 lc, lc the
  // chunk unswizzled (the same for all four rows)
  const int lc = (t & 7) ^ ((t >> 3) & 7);
  float ga[8], ba[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ga[j] = AFFINE ? g0[(size_t)n * Din + d0 + 64 * wg + lc * 8 + j] : 1.f;
    ba[j] = AFFINE ? b0[(size_t)n * Din + d0 + 64 * wg + lc * 8 + j] : 0.f;
  }
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int s = 0; s < steps; ++s) {
    ring.consumer_wait();
    unsigned char* xbox = ring.buf() + wg * DW_BOX;
    if (AFFINE) {  // xt = bf16(x * g0 + b0) in place, then visible to wgmma
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        uint4* p = reinterpret_cast<uint4*>(xbox + ((t >> 3) + 16 * it) * 128 + (t & 7) * 16);
        uint4 raw = *p;
        bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(__bfloat162float(v[j]) * ga[j] + ba[j]);
        *p = raw;
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    }
    const uint32_t xa = smem_u32(xbox), da = smem_u32(ring.buf() + 2 * DW_BOX);
    wg_fence();
    // MN-major, 128-byte swizzle: 64-column blocks DW_BOX apart (leading
    // byte offset), 8-row k groups 1024 B apart (stride byte offset)
#pragma unroll
    for (int k = 0; k < DW_KR / 16; ++k)
      wgmma_k16<2, 1, 1>(acc, 2, make_desc_sw(xa + k * 2048, DW_BOX, 1024, 1),
                         make_desc_sw(da + k * 2048, DW_BOX, 1024, 1), 0, 1);
    wg_commit();
    wg_wait<1>();  // the step before is done: its stage may be refilled
    if (prev >= 0) release_stage(&empty[prev], elected);
    prev = ring.stage;
    ring.advance();
  }
  wg_wait<0>();
  fence_acc(acc);
  if (prev >= 0) release_stage(&empty[prev], elected);

  float* on = out + ((size_t)split * N + n) * Din * H;
  const int wl = warp & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = d0 + wg * 64 + wl * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int col = h0 + j * 64 + (i >> 2) * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(on + (size_t)row * H + col) = make_float2(acc[j][i], acc[j][i + 1]);
    }
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// Row splits of the dW pass: tiles x splits about one wave on the card (one
// block per SM), each split a multiple of DW_KR rows and at least 256 rows.
void dw_split(int N, int B, int Din, int H, int* S, int* rows) {
  const int tiles = (Din / DW_TM) * (H / DW_TN) * N;
  int s = sm_count() / tiles;
  const int max_s = (B + 255) / 256;
  s = s > max_s ? max_s : s;
  s = s < 1 ? 1 : s;
  int r = (B + s - 1) / s;
  r = (r + DW_KR - 1) / DW_KR * DW_KR;
  *S = (B + r - 1) / r;
  *rows = r;
}

// dW of one layer: the dW pass into `dw` (S == 1) or into the partial tiles
// at `dwp`, then their reduction.  x [N or 1][B][Din] (sx = 0: one matrix
// for every agent), dh [N][B][H].  Returns the first error.
template <bool AFFINE>
int launch_dw(int N, int B, int Din, int H, long long sx, const bf16* x, const float* g0,
              const float* b0, const bf16* dh, float* dw, float* dwp, cudaStream_t st) {
  int S, rows;
  dw_split(N, B, Din, H, &S, &rows);
  const int xa = sx == 0 ? 1 : N;
  CUtensorMap xmap, dmap;
  int err = make_map(&xmap, x, Din, B, xa, (uint64_t)Din * 2, (uint64_t)B * Din * 2, 64, DW_KR,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&dmap, dh, H, B, N, (uint64_t)H * 2, (uint64_t)B * H * 2, 64, DW_KR,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = allow_smem(dw_wgmma_kernel<AFFINE>, dw_smem());
  if (err != 0) return err;
  dim3 grid((Din / DW_TM) * (H / DW_TN), N, S);
  dw_wgmma_kernel<AFFINE><<<grid, WS_THREADS, dw_smem(), st>>>(xmap, dmap, N, B, Din, H, xa, rows,
                                                               g0, b0, S > 1 ? dwp : dw);
  err = (int)cudaGetLastError();
  if (err != 0 || S == 1) return err;
  const long long total = (long long)N * Din * H;
  reduce_dw_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(total, S,
                                                                                   dwp, dw);
  return (int)cudaGetLastError();
}

// Bytes of partial dW tiles launch_dw needs at `dwp` (0 when S == 1).
size_t dw_partial_bytes(int N, int B, int Din, int H) {
  int S, rows;
  dw_split(N, B, Din, H, &S, &rows);
  return S > 1 ? align256((size_t)S * N * Din * H * 4) : 0;
}

// ---------------------------------------------------------------------------
// Fixed-order reduction of the row passes' per-block partial sums
// ---------------------------------------------------------------------------
//
// part [N][nblk][P] -> tmp [N][G][P] (level 1: G groups of consecutive
// blocks, each summed in block order, spread over the whole card) -> the
// outputs (level 2: the G group sums in group order).  Column c < HH of P
// goes to vh [HH / H][N][H] (c / H selects the vector), the rest to vd
// [2][N][Din].  The same bits on every run.

int colsum_groups(int N, int nblk, int P) {
  int g = (4 * sm_count() * THREADS) / (N * P);
  g = g > 64 ? 64 : g;
  g = g > nblk ? nblk : g;
  return g < 1 ? 1 : g;
}

size_t colsum_tmp_bytes(int N, int nblk, int P) {
  return align256((size_t)N * colsum_groups(N, nblk, P) * P * 4);
}

__global__ void colsum_partial_kernel(int N, int nblk, int P, int G, const float* __restrict__ part,
                                      float* __restrict__ tmp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y, n = blockIdx.z;
  if (c >= P) return;
  const int per = (nblk + G - 1) / G;
  const int b0 = g * per, b1 = min(nblk, b0 + per);
  const float* p = part + ((size_t)n * nblk) * P + c;
  float s = 0.f;
#pragma unroll 8
  for (int b = b0; b < b1; ++b) s += p[(size_t)b * P];
  tmp[((size_t)n * G + g) * P + c] = s;
}

__global__ void colsum_final_kernel(int N, int P, int G, int HH, int H, int Din,
                                    const float* __restrict__ tmp, float* __restrict__ vh,
                                    float* __restrict__ vd) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * P) return;
  const int n = idx / P, c = idx % P;
  const float* t = tmp + (size_t)n * G * P + c;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += t[(size_t)g * P];
  if (c < HH) {
    vh[((size_t)(c / H) * N + n) * H + c % H] = s;
  } else {
    const int d = c - HH;
    vd[((size_t)(d / Din) * N + n) * Din + d % Din] = s;
  }
}

int launch_colsum(int N, int nblk, int P, int HH, int H, int Din, const float* part, float* tmp,
                  float* vh, float* vd, cudaStream_t st) {
  const int G = colsum_groups(N, nblk, P);
  colsum_partial_kernel<<<dim3((P + THREADS - 1) / THREADS, G, N), THREADS, 0, st>>>(
      N, nblk, P, G, part, tmp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  colsum_final_kernel<<<(N * P + THREADS - 1) / THREADS, THREADS, 0, st>>>(N, P, G, HH, H, Din,
                                                                          tmp, vh, vd);
  return (int)cudaGetLastError();
}

}  // namespace
