"""kernels_per_step.train: device kernels launched in the traced window
over the train steps it holds (a count: each step is one replay of the
same graph)."""


def read(reading):
    tl = reading.timeline
    if tl is None or not tl.units.get("step"):
        return None
    n = len(tl.kernels())
    return n / tl.units["step"] if n else None
