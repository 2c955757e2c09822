"""extract_wait_share: the share of the stream's consumer time spent
waiting for the decode queue, from `extract_features(stats=)`:
wait_s / (wait_s + compute_s + write_s), in %."""


def read(obs):
    s = obs["stats"]
    total = s.get("wait_s", 0.0) + s.get("compute_s", 0.0) + s.get(
        "write_s", 0.0)
    if total <= 0:
        return None
    return 100.0 * s["wait_s"] / total
