"""moe_load_max.dsv2: the routing's straggler load, from the program's
routing counters over the traced window (`train_epoch`'s "routing", rows
per expert and pad slots a MoE layer): the busiest expert's rows over
the mean expert's, averaged over the MoE layers. 1 is an even routing;
K5's longest segment, which its tail waits on, grows with it. None where
the program keeps no counter."""


def read(obs):
    counts = obs.get("routing")
    conf = obs["config"]
    if not counts or "n_routed_experts" not in conf:
        return None
    e = conf["n_routed_experts"]
    shares = []
    for layer in counts:
        rows = layer[:e]
        mean = sum(rows) / e
        if mean > 0:
            shares.append(max(rows) / mean)
    return sum(shares) / len(shares) if shares else None
