"""repro_torch.kernels — hand-written Hopper kernels (sources in
``repro_torch/csrc``), each beside its plain PyTorch version."""
