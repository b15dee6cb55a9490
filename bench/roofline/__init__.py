"""Peaks of the card and the operation and byte counts of the model and
its kernels, from shapes alone."""
