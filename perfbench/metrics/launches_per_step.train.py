"""Device kernels a training step launches: the kernels in the traced
sub-window (copies and sets left out) over the steps it holds."""


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or not facts["trace_steps"]:
        return None
    return t["kernels"] / facts["trace_steps"]
