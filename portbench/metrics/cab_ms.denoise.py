"""Device ms per request of the kernels launched inside the model's
``mambair.cab`` ranges (the blocks' channel-attention branches), from the
traced run's own profile (``traffic/denoise.py``); None where the program has
no such range."""


def read(run):
    return getattr(run, "spans", {}).get("mambair.cab")
