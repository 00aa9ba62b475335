// Pieces shared by the fused MLP kernels of fused_mlp.cu (B2/B3) and
// fused_tower.cu (B4/B5), all on Hopper's wgmma fed by TMA: block constants,
// a warp sum, the bf16 input affine, the PTX building blocks (mbarriers,
// thread-block clusters, a ring of TMA-filled stages, TMA stores, wgmma on
// shared-memory descriptors), a cache of encoded tensor maps, the forward
// of B2 and B4 (one product routine and one epilogue, fwd_body), the
// backward's dW pass and the fixed-order reductions of partial sums.
//
// Shared-memory operand layouts.  Every wgmma operand is a swizzled tile as
// TMA writes it: rows of 128 bytes (64 bf16) in atoms of 8 rows (1024 B),
// 16-byte chunk j of row r stored at chunk j ^ (r % 8) (the 64-byte
// swizzle: rows of 64 B, chunk j ^ ((r / 2) % 4)).
//   * K-major (K contiguous, as A = [M][K] row-major): a tile is
//     [rows][64 k] per atom column; the descriptor's stride byte offset is
//     the 1024 B between 8-row groups and a k16 step adds 32 B to the start
//     (64-byte swizzle: [rows][32 k], 8-row groups 512 B apart);
//   * MN-major (M or N contiguous, as xt = [rows][Din] read as xt^T): a
//     tile is [k rows][64 m] per box; 8-row k groups are 1024 B apart (the
//     stride byte offset), 64-column boxes one box apart (the leading byte
//     offset), and a k16 step adds 2048 B.
// A tile written by the threads themselves (B3's dh16, B4/B5's layer input,
// the forward's output staging) uses the same swizzle, so wgmma and TMA read
// both kinds alike.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float EPS = 1e-6f;  // flax.linen.LayerNorm default epsilon
constexpr int BM = 64;        // rows of a warpgroup product and of a forward work item
constexpr int RED_THREADS = 256;  // the reduction kernels' blocks
constexpr int WS_THREADS = 288;   // the dW pass: two consumer warpgroups + a producer warp
constexpr int CONSUMERS = 256;    // threads of the two consumer warpgroups
// B2/B4 and B3's and B5's row passes: two consumer warpgroups + a producer warpgroup
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
// strides of dims 1 and 2) read or written in boxes b0 x b1 x 1.  Elements
// outside the array read as zeros and are not written.  Returns 0 or a CUDA
// error code.
//
// Encoded maps are cached by their whole geometry (base pointer, dims,
// strides, box, swizzle): a map holds nothing else, so a hit is always the
// map an encode would give, and the caching allocator makes the pointers of
// a training loop repeat.  An encode costs the host microseconds a call.
struct MapKey {
  const void* base;
  uint64_t d0, d1, d2, s1, s2;
  uint32_t b0, b1;
  int swizzle;
};
constexpr int MAP_CACHE = 128;

int make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
             uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle) {
  static std::mutex mu;
  static MapKey keys[MAP_CACHE];
  static CUtensorMap maps[MAP_CACHE];
  static int filled = 0, next = 0;
  MapKey key;
  memset(&key, 0, sizeof key);  // padding too: keys compare with memcmp
  key.base = base;
  key.d0 = d0, key.d1 = d1, key.d2 = d2, key.s1 = s1, key.s2 = s2;
  key.b0 = b0, key.b1 = b1, key.swizzle = (int)swizzle;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i)
    if (memcmp(&keys[i], &key, sizeof key) == 0) {
      *map = maps[i];
      return 0;
    }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1}, estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % MAP_CACHE;
  filled = filled < MAP_CACHE ? filled + 1 : MAP_CACHE;
  return 0;
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

// The same box multicast into the shared memory of every block of the
// cluster in `mask`, at dst's offset there; completes bytes on each block's
// barrier at bar's offset.
__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            uint16_t mask, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory
// at dst; completes bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory at src to box (c0, c1, c2) of `map` (elements outside the
// array are not written), in the issuing thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ---- thread-block clusters

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster (all lanes of a warp together).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}
// Arrives on the mbarrier at bar's offset in block `cta` of the cluster,
// with the default release at the scope of this block: what it orders is
// wgmma's reads of a ring stage, complete before the arrival, against the
// TMA writes that refill the stage.  (A release at cluster scope waits out
// this thread's memory traffic cluster-wide: it took two thirds of the
// products' time.)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}" ::"r"(smem_u32(bar)),
      "r"(cta)
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
// consumer warpgroup of each of the `blocks` blocks that share the stage
// (the cluster's, when its tiles are multicast).
__device__ inline void ring_init(uint64_t* full, uint64_t* empty, int stages, int blocks = 1) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 2 * blocks);
  }
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Consumer side of one stage: after the warpgroup's wgmma group on the
// stage before has finished (wait_group 1 once the current group is
// committed), one thread of the warpgroup frees that earlier stage.  Where
// the stage's tiles are multicast to the CL blocks of a cluster, it is freed
// in every block, since the next fill of it in any block lands in all.
template <int CL = 1>
__device__ __forceinline__ void release_stage(uint64_t* empty, bool elected) {
  if (!elected) return;
  if (CL == 1) {
    mbar_arrive(empty);
  } else {
#pragma unroll
    for (int c = 0; c < CL; ++c) mbar_arrive_cluster(empty, c);
  }
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

// ---------------------------------------------------------------------------
// The forward of B2 and B4: one product routine, one epilogue, one body
// ---------------------------------------------------------------------------

constexpr int MAXL = 8;                      // layers a tower may have
constexpr int FK = 32;                       // K depth of a forward ring stage
constexpr uint32_t FBOX = FK * 128;          // a W box: 64 columns x FK rows, 128-byte swizzle
constexpr uint32_t XT_BYTES = BM * FK * 2;   // a streamed x tile: 64 rows x FK, 64-byte swizzle
constexpr int FWD_CL = 2;                    // blocks of a forward cluster (W multicast to all)

struct Layers {
  const bf16* w[MAXL];
  const float* b[MAXL];
  const float* g[MAXL];
  const float* be[MAXL];
};

// Tensor maps of the forward: x read in [64 rows][FK] boxes, W_l in [FK][64]
// boxes, y and a written in [64 rows][64] boxes.
struct FwdMaps {
  CUtensorMap x, y, a, w[MAXL];
};

// Shared memory of a forward block at width H = 128 HK:
//   act    [64 rows][H] bf16 in 128-byte-swizzled atoms of 64 columns: the
//          input of layers 1 ... (the A operand), and the staging of a and
//          y for their TMA stores;
//   ring   STAGES stages of [x tile | W tile [FK][H] in H / 64 boxes | g0,
//          b0 of the x tile's FK columns], each 1024-byte aligned (the x
//          tile and g0/b0 are filled for layer 0 only);
//   vec    the current layer's bias, LayerNorm scale and bias, [3][H] f32;
//   stats  per-row sums of the two warpgroups, two alternating buffers;
//   bars   full/empty per ring stage.
template <int HK>
struct FwdSmem {
  static constexpr int H = 128 * HK;
  static constexpr uint32_t W_BYTES = FK * H * 2;
  static constexpr uint32_t GB = XT_BYTES + W_BYTES;
  static constexpr uint32_t STAGE = (GB + 2 * FK * 4 + 1023) / 1024 * 1024;
  static constexpr size_t RING = (size_t)BM * H * 2;
  static constexpr size_t FIXED = RING + 3 * H * 4 + 2 * 2 * 64 * 4 + 2 * 8 * 8;
  static constexpr int STAGES =
      (SMEM_MAX - FIXED) / STAGE > 8 ? 8 : (int)((SMEM_MAX - FIXED) / STAGE);
  static constexpr size_t VEC = RING + (size_t)STAGES * STAGE;
  static constexpr size_t STATS = VEC + 3 * H * 4;
  static constexpr size_t BARS = STATS + 2 * 2 * 64 * 4;
  static constexpr size_t TOTAL = BARS + 2 * STAGES * 8;
  static_assert(TOTAL <= SMEM_MAX && STAGES >= 3, "forward shared memory");
};

// One product of a 64-row block, run by both consumer warpgroups: acc =
// A[64 x K] @ W over K in ring stages of FK, nb 64-column blocks per
// warpgroup, the warpgroup's half of the stage's W boxes (at w_off; [FK][64]
// MN-major) starting at box wg * nb.
//   stream: A is the stage's x tile ([64 rows][FK] K-major, 64-byte
//     swizzle), which the 256 consumer threads first turn into xt = bf16(x *
//     g0 + b0) in place, one 16-byte chunk each, with g0 and b0 of its FK
//     columns from the stage (at gb_off); then fence.proxy.async and a
//     barrier over both warpgroups before wgmma reads it.
//   else: A is `act`, resident ([64 rows][K] K-major in 128-byte-swizzled
//     atoms of 64 columns).
// One loop for both (a flag, not a template): two inlined loops on the same
// accumulators made the compiler move them between the loops' registers.
// CL: blocks of the cluster that share every stage (release_stage).
template <int NBA, int CL>
__device__ __forceinline__ void fwd_product(float (&acc)[NBA][32], int nb, uint32_t act, int K,
                                            Ring& ring, uint32_t w_off, uint32_t gb_off, int wg,
                                            bool elected, bool stream) {
  // acc starts from zeros (the first wgmma ignores it, but reads it as an
  // input): the values of the epilogue before are then dead after their
  // last use there.  Left live into the next product, they spilled at H =
  // 384 and 512 (B2, B4 and B5).  Every write completes before the first
  // wgmma.fence: one the compiler moved past it would serialize the
  // products.
#pragma unroll
  for (int j = 0; j < NBA; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int ks = 0; ks < K / FK; ++ks) {
    mbar_wait(&ring.full[ring.stage], ring.phase);  // only TMA wrote the stage: no proxy fence
    unsigned char* buf = ring.buf();
    if (stream) {
      // thread t: physical chunk t % 4 of row t / 4, logical chunk (the
      // columns 8 lc ... of the tile) t % 4 ^ (row / 2) % 4
      const int t = threadIdx.x, r = t >> 2, pc = t & 3, lc = pc ^ ((r >> 1) & 3);
      uint4* q = reinterpret_cast<uint4*>(buf + r * 64 + pc * 16);
      const float* g0 = reinterpret_cast<const float*>(buf + gb_off) + lc * 8;
      const float* b0 = g0 + FK;
      uint4 raw = *q;
      bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(__bfloat162float(v[j]) * g0[j] + b0[j]);
      *q = raw;
      fence_async_smem();
      consumers_sync();
    }
    const uint32_t xa = smem_u32(buf), b = xa + w_off;
    // the A descriptors of the stage's k16 steps, chosen before the first
    // wgmma: a choice between two wgmmas made ptxas fence them apart
    uint64_t da[FK / 16];
#pragma unroll
    for (int k = 0; k < FK / 16; ++k) {
      const int s = ks * 2 + k;  // k16 step: atom s / 4 of act, 32 B per step inside it
      da[k] = stream ? make_desc_sw(xa + k * 32, 16, 512, 2)
                     : make_desc_sw(act + (s >> 2) * (BM * 128) + (s & 3) * 32, 16, 1024, 1);
    }
    wg_fence();
#pragma unroll
    for (int k = 0; k < FK / 16; ++k)  // 64-column boxes FBOX apart, 8-row k groups 1024 B apart
      wgmma_k16<NBA, 0, 1>(acc, nb, da[k],
                           make_desc_sw(b + wg * nb * FBOX + k * 2048, FBOX, 1024, 1), FBOX >> 4,
                           (ks | k) != 0);
    wg_commit();
    wg_wait<1>();  // the step before is done: its stage may be refilled
    if (prev >= 0) release_stage<CL>(&ring.empty[prev], elected);
    prev = ring.stage;
    ring.advance();
  }
  wg_wait<0>();
  fence_acc(acc);
  release_stage<CL>(&ring.empty[prev], elected);
}

// The bf16 pair at (row, col) of a [64 rows][width] tile in 128-byte-swizzled
// atoms of 64 columns: atom col / 64, 16-byte chunk (col % 64) / 8 swizzled
// with row % 8.
__device__ __forceinline__ __nv_bfloat162* act_ptr(unsigned char* act, int row, int col) {
  return reinterpret_cast<__nv_bfloat162*>(act + (col >> 6) * (BM * 128) + row * 128 +
                                           ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// ---- the epilogue, from the accumulators of both warpgroups: warpgroup wg
// holds columns cb = wg * H / 2 ... of all 64 rows, a thread rows ra and
// ra + 8 (register i of block j: row ra + 8 (i & 2) / 2, column acc_col)

__device__ __forceinline__ int acc_col(int cb, int j, int i) {
  return cb + j * 64 + (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// Orders 16 accumulator registers against the code around it: whatever
// computes them before is done before, whatever reads them after starts
// after.  Between two such groups the compiler cannot interleave the work of
// both, which bounds the epilogue's temporaries beside the 128 accumulators
// to one group's.  Only where no wgmma on them is in flight.
template <int O>
__device__ __forceinline__ void fence_group16(float (&d)[32]) {
#pragma unroll
  for (int i = O; i < O + 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// h = acc + bias, a = ELU(h) = h > 0 ? h : exp(h) - 1, in place; the
// thread's partial sums of a over its columns of rows ra (s0), ra + 8 (s1).
// exp - 1 of every element, then a select: branch-free, so the compiler
// interleaves the expf of a group's elements (a branch per element left the
// epilogue waiting on each expf in turn).
template <int NB>
__device__ __forceinline__ void bias_elu(float (&acc)[NB][32], const float* bias, int cb,
                                         float& s0, float& s1) {
  s0 = s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 0) fence_group16<0>(acc[j]);
      else fence_group16<16>(acc[j]);
#pragma unroll
      for (int i = 16 * g; i < 16 * g + 16; i += 2) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + acc_col(cb, j, i));
        float h0 = acc[j][i] + bb.x, h1 = acc[j][i + 1] + bb.y;
        const float e0 = expf(h0) - 1.f, e1 = expf(h1) - 1.f;
        h0 = h0 > 0.f ? h0 : e0;
        h1 = h1 > 0.f ? h1 : e1;
        acc[j][i] = h0;
        acc[j][i + 1] = h1;
        if (i & 2) s1 += h0 + h1;
        else s0 += h0 + h1;
      }
      if (g == 0) fence_group16<0>(acc[j]);
      else fence_group16<16>(acc[j]);
    }
  }
}

// The thread's partial sums of (a - mu)^2 of rows ra (q0), ra + 8 (q1).
// Each group of 16 accumulators is fenced first (fence_group16), which
// bounds how far the compiler runs ahead computing squares.
template <int NB>
__device__ __forceinline__ void sq_dev(float (&acc)[NB][32], float mu0, float mu1, float& q0,
                                       float& q1) {
  q0 = q1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i == 0) fence_group16<0>(acc[j]);
      if (i == 16) fence_group16<16>(acc[j]);
      const float d = acc[j][i] - ((i & 2) ? mu1 : mu0);
      if (i & 2) q1 += d * d;
      else q0 += d * d;
    }
}

// bf16(acc) into act.
template <int NB>
__device__ __forceinline__ void acc_to_act(const float (&acc)[NB][32], unsigned char* act, int cb,
                                           int ra) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *act_ptr(act, ra + ((i & 2) ? 8 : 0), acc_col(cb, j, i)) =
          __floats2bfloat162_rn(acc[j][i], acc[j][i + 1]);
}

// y = (a - mu) * inv * gamma + beta in place of a.  Each group of 16
// accumulators is fenced first, so a - mu is computed here again and not
// kept from the variance pass.
template <int NB>
__device__ __forceinline__ void layer_norm(float (&acc)[NB][32], const float* g, const float* be,
                                           float mu0, float mu1, float inv0, float inv1, int cb) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      if (i == 0) fence_group16<0>(acc[j]);
      if (i == 16) fence_group16<16>(acc[j]);
      const int col = acc_col(cb, j, i);
      const bool lower = (i & 2) != 0;
      const float mu = lower ? mu1 : mu0, inv = lower ? inv1 : inv0;
      const float2 gg = *reinterpret_cast<const float2*>(g + col);
      const float2 bb = *reinterpret_cast<const float2*>(be + col);
      acc[j][i] = (acc[j][i] - mu) * inv * gg.x + bb.x;
      acc[j][i + 1] = (acc[j][i + 1] - mu) * inv * gg.y + bb.y;
    }
  }
}

// act's H / 64 atoms to rows row0 ... of agent n of `map` by TMA (rows past
// the array's end are not written), as one bulk group.
template <int H>
__device__ __forceinline__ void store_act(const CUtensorMap* map, unsigned char* act, int row0,
                                          int n) {
#pragma unroll
  for (int bx = 0; bx < H / 64; ++bx) tma_store(map, act + bx * (BM * 128), 64 * bx, row0, n);
  bulk_commit();
}

// The forward of B2 (L = 1, store_a: y and a) and B4 (L layers, only the
// last y) at width H = 128 HK, in a persistent grid of FWD_CL-block
// clusters.  A work item is FWD_CL consecutive 64-row blocks of one agent,
// one per block of the cluster; clusters walk the items in order, so the
// whole grid works on one agent's W at a time.  A block whose rows lie past
// B (a ragged tail) runs every product and stores nothing.
//   Producer warp (a warpgroup under setmaxnreg 40): per layer and K step of
//   FK, one ring stage: layer 0's x tile and its g0/b0 for this block's rows
//   (rows past B read as zeros), and the W tile, each of its 64-column boxes
//   loaded once by one block and multicast to the cluster.  It runs ahead
//   into the next item while the consumers finish this one.
//   Consumers (two warpgroups, 232 registers): per layer, fwd_product into
//   the accumulators (layer 0 streams x, later layers read act), then the
//   epilogue from the accumulators: bias and ELU, the row statistics across
//   the warpgroups (row_allreduce2), the LayerNorm, bf16(y) into act; the
//   last layer's y (and B2's a, staged in act before y) leave by TMA stores
//   that run on under the next item's products.
template <int HK>
__device__ __forceinline__ void fwd_body(const FwdMaps& maps, int N, int B, int Din, int L,
                                         int x_agents, bool store_a, const float* __restrict__ g0,
                                         const float* __restrict__ b0, const Layers& p) {
  constexpr int H = 128 * HK, CL = FWD_CL;
  constexpr float INV_H = 1.f / H;  // a mean is the sum times 1/H, as torch's mean computes it
  using S = FwdSmem<HK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* act = smem;
  float* vec = reinterpret_cast<float*>(smem + S::VEC);
  float* stats = reinterpret_cast<float*>(smem + S::STATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank();
  if (tid == 0) ring_init(full, empty, S::STAGES, CL);
  mbar_init_fence();
  __syncwarp();
  cluster_sync();  // every block's barriers are set before any multicast or remote arrival
  Ring ring{full, empty, smem + S::RING, S::STAGE, S::STAGES, 0, 0};
  const int nblk = (B + BM - 1) / BM, per_agent = (nblk + CL - 1) / CL, items = N * per_agent;
  const int first = (int)cluster_id(), stride = (int)cluster_count();

  if (warp >= 8) {  // ---- producer
    regs_dealloc<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      const uint16_t mask = (uint16_t)((1u << CL) - 1);
      for (int item = first; item < items; item += stride) {
        const int n = item / per_agent, row0 = ((item % per_agent) * CL + rank) * BM;
        const int nx = x_agents > 1 ? n : 0;
        for (int l = 0; l < L; ++l) {
          const int K = l == 0 ? Din : H;
          for (int ks = 0; ks < K / FK; ++ks) {
            ring.producer_acquire();
            unsigned char* buf = ring.buf();
            uint64_t* bar = &full[ring.stage];
            mbar_expect_tx(bar, S::W_BYTES + (l == 0 ? XT_BYTES + 2 * FK * 4 : 0));
            if (l == 0) {
              tma_load(buf, &maps.x, bar, ks * FK, row0, nx);
              bulk_load(buf + S::GB, g0 + (size_t)n * Din + ks * FK, FK * 4, bar);
              bulk_load(buf + S::GB + FK * 4, b0 + (size_t)n * Din + ks * FK, FK * 4, bar);
            }
            for (int bx = rank; bx < H / 64; bx += CL)
              tma_load_mc(buf + XT_BYTES + bx * FBOX, &maps.w[l], bar, mask, 64 * bx, ks * FK, n);
            ring.advance();
          }
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    // ---- consumers: warpgroup wg computes columns cb ... of every product
    const int wg = warp >> 2, cb = wg * (H / 2);
    const bool elected = (tid & 127) == 0;
    const int ra = (warp & 3) * 16 + (lane >> 2);
    const uint32_t act_u = smem_u32(act);
    int sb = 0;  // the stats buffer of the next row reduction
    auto rows_sum = [&](float& v0, float& v1) {
      row_allreduce2(v0, v1, stats + sb * 128, wg, ra);
      sb ^= 1;
    };
    float acc[HK][32];
    for (int item = first; item < items; item += stride) {
      const int n = item / per_agent, row0 = ((item % per_agent) * CL + rank) * BM;
      const bool store = row0 < B;
      for (int l = 0; l < L; ++l) {
        const bool last = l == L - 1, with_a = store_a && last;
        // vectors are read from shared memory, staged once per layer
        for (int c = tid; c < 3 * H; c += CONSUMERS) {
          const int q = c / H;
          const float* src = q == 0 ? p.b[l] : q == 1 ? p.g[l] : p.be[l];
          vec[c] = src[(size_t)n * H + c - q * H];
        }
        fwd_product<HK, CL>(acc, HK, act_u, l == 0 ? Din : H, ring, XT_BYTES, S::GB, wg, elected,
                            l == 0);
        if (tid == 0) bulk_wait_read<0>();  // the stores before have read act
        consumers_sync();                   // (and vec is staged)
        float s0, s1, q0, q1;
        bias_elu<HK>(acc, vec, cb, s0, s1);
        if (with_a) {  // a leaves first, through act
          acc_to_act<HK>(acc, act, cb, ra);
          fence_async_smem();
        }
        rows_sum(s0, s1);
        if (with_a && tid == 0 && store) store_act<H>(&maps.a, act, row0, n);
        const float mu0 = s0 * INV_H, mu1 = s1 * INV_H;
        sq_dev<HK>(acc, mu0, mu1, q0, q1);
        rows_sum(q0, q1);  // both warpgroups are past their products: act may take the output
        const float inv0 = rsqrtf(q0 * INV_H + EPS), inv1 = rsqrtf(q1 * INV_H + EPS);
        layer_norm<HK>(acc, vec + H, vec + 2 * H, mu0, mu1, inv0, inv1, cb);  // y, in registers
        if (with_a) {  // (a's store ran on under the LayerNorm)
          if (tid == 0) bulk_wait_read<0>();  // a's store has read act
          consumers_sync();
        }
        acc_to_act<HK>(acc, act, cb, ra);
        fence_async_smem();  // the next layer's wgmma or the y store reads act
        consumers_sync();
        if (last && tid == 0 && store) store_act<H>(&maps.y, act, row0, n);
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
  __syncwarp();
  cluster_sync();  // no block leaves while another may multicast into it or arrive on its barriers
}

// Launches a forward kernel (fwd_body) on the card in FWD_CL-block clusters,
// at most as many as can be resident at once (found once per kernel, kept
// in *max_clusters), each walking work items.  Returns 0 or a CUDA error.
template <typename Kern, typename... Args>
int launch_fwd_clusters(Kern kernel, size_t smem, int* max_clusters, int N, int B,
                        cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FWD_CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(RP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (*max_clusters == 0) {
    int err = allow_smem(kernel, smem);
    if (err != 0) return err;
    cfg.gridDim = dim3(FWD_CL * sm_count());
    int mc = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&mc, (const void*)kernel, &cfg);
    if (err != 0) return err;
    if (mc < 1) return (int)cudaErrorInvalidConfiguration;
    *max_clusters = mc;
  }
  const int nblk = (B + BM - 1) / BM, items = N * ((nblk + FWD_CL - 1) / FWD_CL);
  cfg.gridDim = dim3((items < *max_clusters ? items : *max_clusters) * FWD_CL);
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
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
  reduce_dw_kernel<<<(unsigned)((total + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0, st>>>(total, S,
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
  int g = (4 * sm_count() * RED_THREADS) / (N * P);
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
  colsum_partial_kernel<<<dim3((P + RED_THREADS - 1) / RED_THREADS, G, N), RED_THREADS, 0, st>>>(
      N, nblk, P, G, part, tmp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  colsum_final_kernel<<<(N * P + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, st>>>(N, P, G, HH, H, Din,
                                                                          tmp, vh, vd);
  return (int)cudaGetLastError();
}

}  // namespace
