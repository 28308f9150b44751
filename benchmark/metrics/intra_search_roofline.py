"""intra_search_roofline: the least time the all-intra search of the
window's frames needs on one H100 (harness/work.py: one function per size
class, the larger of its bytes over 3.35 TB/s and its operations over
67 T/s) over the union of the device time of every kernel of the traced
window (torch.profiler)."""
from harness.work import intra_search_work, least_seconds


def read(run):
    tr = run.trace
    frames = len(run.in_window)
    if tr is None or not frames:
        return None
    kernel_s = tr.busy_s({"kernel"})
    if kernel_s <= 0:
        return None
    c = run.config
    nbytes, ops = intra_search_work(int(c["width"]), int(c["height"]),
                                    int(c["bitdepth"]))
    return 100.0 * frames * least_seconds(nbytes, ops) / kernel_s
