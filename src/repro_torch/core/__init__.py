"""repro_torch.core — NFP budget math (copied from the reference's
framework-free modules), the H100 hardware spec and device selection."""
