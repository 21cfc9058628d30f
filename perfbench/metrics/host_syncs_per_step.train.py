"""Host-blocking synchronizations a training step makes inside the
program's spans: the count of ``basi_tpu_torch.utils.profiling.report``
(torch's sync debug mode, on while a span records on the card: blocking
copies, ``.item()``, stream and device synchronizes) over the traced
sub-window, divided by its steps. Silent where the run was not traced, ran
on no CUDA device, or the program has no such counter."""

import torch


def read(facts):
    if (facts.get("kind") != "train" or facts.get("trace") is None
            or not facts.get("trace_steps") or not torch.cuda.is_available()):
        return None
    from basi_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)
    if report is None:
        return None
    got = report()
    if not any(s["device_s"] is not None for s in got["spans"].values()):
        return None
    return got["syncs"]["count"] / facts["trace_steps"]
