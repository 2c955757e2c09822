"""moe_roofline.dsv2: the sum of K5's bounds over the window's
microbatches and MoE layers, divided by the device time of K5's kernels
in the trace (the union of `moe_rows_kernel*` and `moe_wgrad_kernel`
intervals), in %.

K5 runs, a MoE layer a microbatch, the routed experts' forward (gate and
up with the SwiGLU, then down) and backward (dX through both, and dW of
both added into the gradients). The work those inputs need, with r = k
times the microbatch's valid tokens (pad tokens are not routed):
operations 3 (2 r D 2F + 2 r F D), the forward and twice that backward;
bytes: the experts' weights read forward and again for dX, their
gradients read and written by dW, and each launch's rows in and out. Each
(layer, microbatch)'s bound is the longer of its operations at the
float32 peak and its bytes at the HBM rate."""

import peaks


def k5_ops(rows: int, d: int, f: int) -> float:
    return 3.0 * (2 * rows * d * 2 * f + 2 * rows * f * d)


def k5_bytes(rows: int, d: int, f: int, experts: int) -> float:
    weights = experts * 3 * f * d
    # rows: xs in, gu and act out; act in, ys out; dys and gu in, dgu out;
    # dgu in, dxs out; dys and act in (dW2); dgu and xs in (dW13)
    per_row = 7 * d + 13 * f
    return 4.0 * (4 * weights + rows * per_row)


def k5_bound_s(rows: int, d: int, f: int, experts: int) -> float:
    return peaks.bound_s(k5_bytes(rows, d, f, experts), k5_ops(rows, d, f),
                         peaks.FLOAT32_FLOPS)


def is_k5(name: str) -> bool:
    return "moe_rows_kernel" in name or "moe_wgrad_kernel" in name


def read(obs):
    window = obs["window"]
    busy = window.busy_s(is_k5)
    conf = obs["config"]
    if busy <= 0 or not obs.get("batches") or "n_routed_experts" not in conf:
        return None
    d, f = conf["hidden_size"], conf["moe_intermediate_size"]
    e, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    moe_layers = conf["num_hidden_layers"] - conf["first_k_dense_replace"]
    bound = sum(moe_layers * k5_bound_s(k * int(t.sum()), d, f, e)
                for _, t in obs["batches"])
    return 100.0 * bound / busy
