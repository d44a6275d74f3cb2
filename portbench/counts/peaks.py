"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit; a card set below it runs slower under load, so a share is
printed with the card's power limit beside it)."""

PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores (TF32 off)
PEAK_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3
