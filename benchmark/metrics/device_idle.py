"""device_idle: 1 minus the union of every device interval (kernels,
copies, fills) of the traced window over its length (torch.profiler)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.events or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
