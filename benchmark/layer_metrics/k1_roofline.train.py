"""k1_roofline.train: the sum of K1's bounds over the window's updates,
divided by the device time of K1's kernels in the trace (the union of
`gru_step_kernel*` and `gru_bwd_*` intervals), in %.

A microbatch runs K1 forward and backward for each bi-GRU: the visual
one (H = visual_rnn_size) and, with the bi-GRU text tower, the text one
(H = text_rnn_size). The work those inputs need: both directions over
the batch's longest valid length T (frames, or tokens), B rows, the
recurrent product 2 T B 3H H a direction forward and twice that
backward; bytes: the recurrent weights, the input contributions and the
outputs, read or written once. Each call's bound is the longer of its
operations at the float32 peak and its bytes at the HBM rate."""

import peaks


def k1_bound_s(b: int, t: int, h: int) -> float:
    ops = 2 * (2 * t * b * 3 * h * h)
    fwd_bytes = 4 * (2 * 3 * h * h + 2 * t * b * 3 * h + 2 * t * b * h)
    bwd_bytes = 4 * (2 * 3 * h * h + 2 * 2 * t * b * 3 * h
                     + 2 * 2 * t * b * h)
    return (peaks.bound_s(fwd_bytes, ops, peaks.FLOAT32_FLOPS)
            + peaks.bound_s(bwd_bytes, 2 * ops, peaks.FLOAT32_FLOPS))


def is_k1(name: str) -> bool:
    return "gru_step_kernel" in name or "gru_bwd_" in name


def read(obs):
    window = obs["window"]
    busy = window.busy_s(is_k1)
    if busy <= 0 or not obs.get("batches"):
        return None
    model = obs["config"]["model"]
    bound = 0.0
    for vlens, tlens in obs["batches"]:
        b = len(vlens)
        bound += k1_bound_s(b, int(max(vlens)), model["visual_rnn_size"])
        if model["text_net"] == "bi-gru":
            bound += k1_bound_s(b, int(max(tlens)), model["text_rnn_size"])
    return 100.0 * bound / busy
