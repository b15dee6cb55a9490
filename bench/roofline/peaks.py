"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # FLOP/s, bf16 / fp16 tensor cores
HBM_BYTES_S = 3.35e12      # bytes/s, HBM3
