"""Fused grouped expert FFN on Hopper: ``ops`` holds the block alignment,
the kernel's wrappers and its plain version."""
