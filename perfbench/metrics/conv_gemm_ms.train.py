"""Device milliseconds a training step spends in convolutions and GEMMs
(cuDNN, cuBLAS, CUTLASS kernels; forward and backward), from the traced
sub-window."""

from perfbench.harness.trace import class_seconds


def read(facts):
    t = facts.get("trace")
    if facts.get("kind") != "train" or t is None or not facts["trace_steps"]:
        return None
    return 1e3 * class_seconds(t, "conv_gemm") / facts["trace_steps"]
