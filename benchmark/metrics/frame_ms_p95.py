"""frame_ms_p95: the 95th percentile, over every frame the window started,
of the time from the frame's first call (its batch's dispatch, or its
feed) to the return of the call that gives back its access unit (the
benchmark's own spans, host clock)."""
import numpy as np


def read(run):
    lat = [run.done[g] - run.first[g] for g in run.in_window
           if g in run.done]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
