"""The ``bn_stats`` kernels' share of their bound in a training step, both
kernels together: the frozen bound of a step's 53 ``channel_moments`` and
53 ``channel_dual_sums`` calls (``harness/roofline.py``) times the steps
in the traced sub-window, over the two kernels' device time there. Silent
where they did not run (``model.bn_impl=xla``)."""

from perfbench.harness.trace import class_seconds


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or not facts["trace_steps"]:
        return None
    s = class_seconds(t, "bn_stats")
    if s <= 0:
        return None
    bound_ms = facts["bn_stats_bound_ms_per_step"] * facts["trace_steps"]
    return 100.0 * bound_ms / (1e3 * s)
