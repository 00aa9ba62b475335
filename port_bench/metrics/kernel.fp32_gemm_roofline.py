"""The float32 products' share of their roofline: the counted float32 matmul
work of the profiled iterations (work["fp32_flop"]: the GRU's input and
recurrent products, roofline/gru.py, and the heads, forward and backward)
at the float32 peak, over the device time of cuBLAS's float32 GEMM kernels
(TF32 off).  Nothing to read without a trace or without such a kernel."""
from port_bench import peaks

# cuBLAS's float32 products with TF32 off, by the names the profiler gives
# their kernels on the H100 (torch 2.11, CUDA 12.8): CUTLASS's SIMT SGEMM
# (`cutlass_80_simt_sgemm_256x128_8x4_nn_align1`), cuBLAS's FFMA GEMM
# (`sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_..._ffma_...`) and
# its float32 GEMV (`gemv2T_kernel_val<int, int, float, float, float,
# float, ...>`, `internal::gemvx::kernel<int, int, float, float, float,
# float, ...>`); TF32 and bf16 kernels name their types otherwise
FP32_GEMM = ("simt_sgemm", "gemm_f32f32_f32f32_f32", "gemv2T_kernel_val<int, int, float, float, float, float",
             "gemv2N_kernel<int, int, float, float, float, float",
             "gemvx::kernel<int, int, float, float, float, float")


def read(r):
    if r.trace is None:
        return None
    s = sum(t for name, (_, t) in r.trace.kernels.items() if any(k in name for k in FP32_GEMM))
    if s == 0:
        return None
    return 100.0 * r.work["fp32_flop"] * r.trace.iterations / peaks.FP32_OPS_PER_S / s
