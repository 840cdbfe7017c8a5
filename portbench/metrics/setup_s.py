"""Set-up: from the start of the run's process to the start of the window
(imports, card, inputs, model, kernels loaded or built, the cell's shapes
warmed), by the host clock."""

def read(run):
    return run.setup_s
