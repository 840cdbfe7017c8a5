"""Device kernels launched per request, counted in the traced stretch."""

def read(run):
    if run.trace is None or not run.trace.iters:
        return None
    return len(run.trace.kernels()) / run.trace.iters
