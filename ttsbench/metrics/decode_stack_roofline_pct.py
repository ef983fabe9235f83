"""The decode-stack kernel's share of its roofline in the traced slice:
the bound of every call the slice's b1 frames need (counts.decode_stack_call:
one a frame, at that frame's valid positions and attended slots) over the
kernel's device time by name. A frame decoded past a request's length
counts in the time, not in the work."""

from ttsbench import counts

FUNCTIONS = ("stack_kernel",)


def read(run):
    s = run.slice
    if s is None:
        return None
    kernel_s = s.kernel_s(FUNCTIONS)
    if kernel_s <= 0:
        return None
    dtype = run.cfg["dtype"]
    ms = 0.0
    for r in s.records:
        if len(r.rows) != 1:
            continue
        row = r.rows[0]
        for i in range(row["frames"]):
            valid = row["voice_len"] + row["tokens"] + i
            attended = row["voice_slots"] + r.pad_to + i
            ms += counts.bound(*counts.decode_stack_call(run.cfg, valid, attended, dtype),
                               dtype)[0]
    return 100.0 * ms / (kernel_s * 1e3)
