"""forward_idle.extract: the share of the traced window in which no
device operation runs while the extraction loop is in its forward (the
program's span `extract.forward`: the extractor's launches and the fetch
of its rows), in %."""

import program_spans


def read(obs):
    return program_spans.idle_share(obs["window"], "extract.forward")
