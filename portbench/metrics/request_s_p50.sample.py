"""request_s_p50.sample: the median request time of the run's window, on
the host's clock (a median of pieces: per-layer only)."""


def read(reading):
    return reading.outcome.extra.get("request_s_p50")
