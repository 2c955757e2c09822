"""host_step_ms.train: the median length, in ms, of the program's
`train.step` spans in the traced window: the host's time to enqueue one
update (A microbatches' forward and backward, the clip and Adam)."""

import program_spans


def read(obs):
    return program_spans.median_ms(obs["window"], "train.step")
