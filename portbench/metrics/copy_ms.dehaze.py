"""Device time of the copies between host and card (uploads and downloads) per
request, from the traced stretch."""

def read(run):
    if run.trace is None or not run.trace.iters:
        return None
    return sum(e - s for _, s, e in run.trace.copies()) / 1e3 / run.trace.iters
