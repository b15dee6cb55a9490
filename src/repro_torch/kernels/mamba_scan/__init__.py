"""Mamba1 selective scan on Hopper: ``ops`` holds the chunk padding, the
kernel's wrappers and its plain version."""
