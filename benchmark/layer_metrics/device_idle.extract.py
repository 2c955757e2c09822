"""The share of the traced window in which no operation ran on the
device (the union of the trace's device intervals), in %."""


def read(obs):
    window = obs["window"]
    if not window.ops:
        return None
    return 100.0 * (1.0 - window.busy_s() / window.seconds)
