"""htod_ms: host-to-device copy time of the traced window (torch.profiler)
per frame the window started."""


def read(run):
    tr = run.trace
    frames = len(run.in_window)
    if tr is None or not frames:
        return None
    s = tr.seconds("htod")
    if s <= 0:
        return None
    return s * 1e3 / frames
