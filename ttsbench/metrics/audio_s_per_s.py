"""Audio seconds emitted in the window over the window's seconds (the
request in flight at the close counted in full)."""


def read(run):
    if not run.records:
        return None
    return sum(r.audio_s for r in run.records) / run.window_s
