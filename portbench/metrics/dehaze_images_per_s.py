"""Images dehazed over the whole window divided by the window, by the host
clock."""

def read(run):
    return run.images / run.window_s if run.window_s else None
