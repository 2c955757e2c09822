"""step_idle.train: the share of the traced window in which no device
operation runs while the host is inside `train/step.train_step` (the
program's span `train.step`): the card outrunning the step's launches,
in %."""

import program_spans


def read(obs):
    return program_spans.idle_share(obs["window"], "train.step")
