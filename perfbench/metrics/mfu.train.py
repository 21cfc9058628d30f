"""The whole training step's share of the card's bf16 dense peak (989
TFLOP/s): three times the train-mode forward's operations
(``harness/flops.py``) per step, times the steps in the traced sub-window,
over its length."""

from perfbench.harness.roofline import H100


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or t["window_s"] <= 0:
        return None
    done = facts["flops_per_step"] * facts["trace_steps"]
    return 100.0 * done / t["window_s"] / H100["bf16_flops"]
