"""dispatch_ms: the host's time in SliceEncoder.dispatch_frames_search (the
benchmark's span around each call) per frame it dispatched in the
window."""


def read(run):
    spans = [t1 - t0 for (name, t0, t1) in run.spans if name == "dispatch"
             and t0 < run.t_end]
    frames = len(run.in_window)
    if not spans or not frames:
        return None
    return sum(spans) * 1e3 / frames
