"""``tokenize_roofline``: kernel A's (``csrc/tokenize.cu``) share of its
bandwidth bound.  The least bytes of one call at the configuration's
block (frozen formula) over the peak, against the kernel's device time
in the traced window over its launches there (the port's counter)."""

from benchmark.frozen import profile, roofline


def read(record):
    t = record.get("trace")
    n = (t or {}).get("launches", {}).get("tokenize")
    if not n:
        return None
    e = record["config"]["engine"]
    least = roofline.tokenize_min_bytes(e["block_lines"], e["line_width"],
                                        e["emits_per_line"], e["key_width"])
    return roofline.roofline_pct(least, profile.kernel_seconds(t, "tokenize_kernel") / n,
                                 record.get("device_name"))
