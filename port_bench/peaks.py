"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  A card set below that limit runs slower
under load: every result line carries the card's power limit beside it."""
BF16_OPS_PER_S = 989e12      # bf16 and fp16 tensor cores
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # device memory bandwidth
