"""The model's operations for the frames emitted in the traced slice
(counts.frame_flops: each row's frame at its attended positions) over the
slice's seconds times the H100's dense bf16 peak."""

from ttsbench import counts


def read(run):
    s = run.slice
    if s is None or not s.records:
        return None
    flops = 0
    for r in s.records:
        for row in r.rows:
            base = row["voice_len"] + row["tokens"]
            flops += sum(counts.frame_flops(run.cfg, base + i) for i in range(row["frames"]))
    return 100.0 * flops / (s.window_s * counts.PEAK_FLOPS["bfloat16"])
