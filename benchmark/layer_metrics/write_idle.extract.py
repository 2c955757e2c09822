"""write_idle.extract: the share of the traced window in which no device
operation runs while the extraction loop writes a batch's rows to the
BigFile (the program's span `extract.write`), in %."""

import program_spans


def read(obs):
    return program_spans.idle_share(obs["window"], "extract.write")
