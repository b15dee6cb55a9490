"""Tokens of every train step completed in the window over the window's
seconds (the window ends in a ``synchronize``)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["tokens"] / rec["window_s"]
