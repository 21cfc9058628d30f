"""Host milliseconds per ``Trainer.train_step`` call in the training
window: the harness's span around the call (launches of the whole step;
the call waits where the device's queue is full)."""


def read(facts):
    spans = facts.get("train_step_call_s") if facts.get("kind") == "train" else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
