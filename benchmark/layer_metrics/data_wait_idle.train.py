"""data_wait_idle.train: the share of the traced window in which no
device operation runs while the trainer waits on the prefetch queue (the
program's span `data.wait`, around the consumer's get in
`data/loader.prefetch_to_device`), in %."""

import program_spans


def read(obs):
    return program_spans.idle_share(obs["window"], "data.wait")
