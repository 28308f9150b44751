"""fps: every frame whose access unit the window completed, over all the
time from the window's start to the last of those completions (host
clock)."""


def read(run):
    done = run.completed_in_window()
    if not done or done[-1] <= run.t_start:
        return None
    return len(done) / (done[-1] - run.t_start)
