"""The forward depthwise convolutions' share of their bound in a training
step: the frozen bound of a forward's depthwise convs
(``harness/roofline_convnext.py``: one bf16 read of each input, one bf16
write of each output, the weights and bias, 98 operations an output
element) times the steps in the traced sub-window, over the device time of
the program's ``convnext.dwconv`` span there
(``basi_tpu_torch.utils.profiling.report``). Silent where the run was not
traced, ran on no CUDA device, or the program has no such span."""


def read(facts):
    bound = facts.get("convnext_dwconv_bound_ms_per_step")
    if (facts.get("kind") != "train" or facts.get("trace") is None
            or not facts.get("trace_steps") or bound is None):
        return None
    from basi_tpu_torch.utils import profiling

    report = getattr(profiling, "report", None)
    got = report()["spans"].get("convnext.dwconv") if report else None
    if not got or not got["device_s"]:
        return None
    return 100.0 * bound * facts["trace_steps"] / (1e3 * got["device_s"])
