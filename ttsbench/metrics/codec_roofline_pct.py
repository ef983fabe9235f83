"""The codec kernel's share of its roofline in the traced slice: the
bound of every call the slice's requests need (one a block of the block
ramp, counts.blocks, at T0 = 16 x the block's frames that are served:
counts.codec_call) over the kernel's device time by name."""

from ttsbench import counts

FUNCTIONS = ("conv_kernel", "convtr_kernel", "conv_tc_kernel")


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
        frames = max(row["frames"] for row in r.rows)
        done = 0
        for k in counts.blocks(frames):
            need = min(k, frames - done)
            call = counts.codec_call(run.cfg, len(r.rows), counts.CODEC_STEPS_PER_FRAME * need,
                                     dtype)
            ms += counts.bound(*call, dtype)[0]
            done += k
    return 100.0 * ms / (kernel_s * 1e3)
