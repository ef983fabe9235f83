"""The flash-decode kernel's share of its roofline in the traced slice:
the bound of every call the slice's batched frames need (one a layer a
frame, counts.flash_decode_call over the rows' valid positions) over the
kernel's device time by name."""

from ttsbench import counts

FUNCTIONS = ("flash_decode_kernel",)


def read(run):
    s = run.slice
    if s is None:
        return None
    kernel_s = s.kernel_s(FUNCTIONS)
    if kernel_s <= 0:
        return None
    dtype = run.cfg["dtype"]
    layers = run.cfg["flow_lm"]["transformer"]["num_layers"]
    ms = 0.0
    for r in s.records:
        if len(r.rows) < 2:
            continue
        slots = max(row["voice_slots"] for row in r.rows) + r.pad_to
        for i in range(max(row["frames"] for row in r.rows)):
            valid = sum(row["voice_len"] + row["tokens"] + i for row in r.rows)
            call = counts.flash_decode_call(run.cfg, len(r.rows), valid, slots + i, dtype)
            ms += layers * counts.bound(*call, dtype)[0]
    return 100.0 * ms / (kernel_s * 1e3)
