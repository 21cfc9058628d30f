"""The ``upsample_int`` backward kernel's share of its bound in a training
step: the frozen bound of a step's nine calls (``harness/roofline.py``)
times the steps in the traced sub-window, over the kernel's device time
there (the sub-window opens and closes on an idle device, so it holds
whole steps). Silent where the kernel did not run."""

from perfbench.harness.trace import class_seconds


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or not facts["trace_steps"]:
        return None
    s = class_seconds(t, "upsample_int_bwd")
    if s <= 0:
        return None
    bound_ms = facts["upsample_int_bwd_bound_ms_per_step"] * facts["trace_steps"]
    return 100.0 * bound_ms / (1e3 * s)
