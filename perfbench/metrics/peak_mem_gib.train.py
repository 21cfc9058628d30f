"""The training window's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), GiB."""


def read(facts):
    if facts.get("kind") != "train" or not facts["memory_peak_bytes"]:
        return None
    return facts["memory_peak_bytes"] / 2 ** 30
