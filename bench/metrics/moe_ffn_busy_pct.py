"""The MoE kernel's two phases' device time over all device time in the
profiled stretch."""

PATTERN = r"\b(up_kernel|down_kernel)\b"


def read(rec):
    st = rec.get("stretch")
    if st is None or st.busy_s <= 0:
        return None
    t = st.op_seconds(PATTERN)
    return 100.0 * t / st.busy_s if t > 0 else None
