"""Output tokens streamed to all clients in the window (first tokens
included) over the window's seconds."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["tokens"] / rec["window_s"]
