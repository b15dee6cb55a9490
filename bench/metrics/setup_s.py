"""Process start to the first timed operation: weights made from the
seed, kernels built or loaded, every graph the cell replays captured."""


def read(rec):
    return rec["setup_s"]
