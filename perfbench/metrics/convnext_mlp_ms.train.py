"""Device milliseconds a training step's forward spends in the program's
``convnext.mlp`` span, its calls summed: the blocks' MLPs (``models/convnext.py``: Linear, GELU, Linear and the layer scale ``gamma``). From each call's
entry event to its exit event on the step's stream, idle time inside
included, summed over the traced sub-window and divided by its steps
(``basi_tpu_torch.utils.profiling.report``). The backward is not in it.
Silent where the run was not traced, ran on no CUDA device, or the program
has no such span."""

SPAN = "convnext.mlp"


def read(facts):
    if (facts.get("kind") != "train" or facts.get("trace") is None
            or not facts.get("trace_steps")):
        return None
    from basi_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)
    got = report()["spans"].get(SPAN) if report is not None else None
    if not got or got["device_s"] is None:
        return None
    return 1e3 * got["device_s"] / facts["trace_steps"]
