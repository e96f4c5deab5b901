"""``bitonic_roofline``: kernel B's (``csrc/bitonic.cu``) share of its
bandwidth bound.  A fold sorts the table and the block's emits together:
n = table_size + block_lines * emits_per_line keys with key_width / 4 + 1
payload words (frozen formula).  Against the device time of the
kernel's launches in the traced window over the whole sorts there (the
port's counter)."""

from benchmark.frozen import profile, roofline


def read(record):
    t = record.get("trace")
    n = (t or {}).get("launches", {}).get("bitonic")
    if not n:
        return None
    e = record["config"]["engine"]
    keys = e["table_size"] + e["block_lines"] * e["emits_per_line"]
    least = roofline.bitonic_min_bytes(keys, e["key_width"] // 4 + 1)
    return roofline.roofline_pct(least, profile.kernel_seconds(t, "bitonic_") / n,
                                 record.get("device_name"))
