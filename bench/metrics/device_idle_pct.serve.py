"""1 - (union of device operation intervals / wall) over the profiled
stretch of a serving window."""


def read(rec):
    st = rec.get("stretch")
    if rec["kind"] != "serve" or st is None or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
