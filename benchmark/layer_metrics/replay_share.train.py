"""replay_share.train: the share, in %, of the traced window's training
steps (the program's `train.step` spans) that hold a replay of the
update's CUDA graph (a `train.replay` span): 100 where every update in
the window is one graph launch. Steps cut by the window's edges are left
out. None where the window holds no step, or the program records no
replay span (one from before the graph existed)."""

import program_spans


def read(obs):
    window = obs["window"]
    if not window.ops:
        return None
    spans = program_spans.spans(window)
    replays = [(s, e) for n, s, e, _ in spans if n == "train.replay"]
    steps = [(s, e) for n, s, e, _ in spans
             if n == "train.step" and 0.0 < s and e < window.seconds]
    if not replays or not steps:
        return None
    held = sum(any(s <= rs and re <= e for rs, re in replays)
               for s, e in steps)
    return 100.0 * held / len(steps)
