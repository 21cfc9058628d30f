"""The share of the traced training sub-window in which no kernel, copy or
set ran on the device."""


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
