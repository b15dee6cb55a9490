"""The paged decode-attention kernel's least time (each active row's
committed K/V plus the new position read once, q read and the output
written once; ``roofline.counts``), summed over the profiled stretch's
launches, over the kernel's device time there."""

PATTERN = r"\battn_kernel\b"


def read(rec):
    st = rec.get("stretch")
    if st is None or "attn_bound_s" not in rec:
        return None
    t = st.op_seconds(PATTERN)
    return 100.0 * rec["attn_bound_s"] / t if t > 0 else None
