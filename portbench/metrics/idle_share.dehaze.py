"""The share of the traced stretch in which the card ran nothing: 1 - the union
of device events' intervals over the stretch."""

from portbench import trace


def read(run):
    return None if run.trace is None else 100.0 * trace.idle_share(run.trace)
