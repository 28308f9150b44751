"""launches_per_frame: the port's kernel launches (kernels.LAUNCHES summed
over kernels) from the window's start until every frame it started is
done, per frame the window started. A count."""


def read(run):
    frames = len(run.in_window)
    if not run.launches or not frames:
        return None
    return run.launches / frames
