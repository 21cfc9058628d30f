"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""


def launch_counters() -> dict:
    """Each kernel wrapper of the port by name; each carries ``launches``,
    the count of its kernel's launches."""
    from basi_tpu_torch.kernels.bn_apply import bn_apply, bn_input_gradient
    from basi_tpu_torch.kernels.bn_stats import (
        channel_dual_sums,
        channel_moments,
    )
    from basi_tpu_torch.kernels.dwconv import (
        dwconv_forward,
        dwconv_input_grad,
        dwconv_weight_grad,
    )
    from basi_tpu_torch.kernels.normalize_aug import normalize_and_flip
    from basi_tpu_torch.kernels.upsample_int import (
        upsample_int,
        upsample_int_backward,
    )
    from basi_tpu_torch.kernels.upsample_sigmoid import upsample_sigmoid

    return {"upsample_int": upsample_int,
            "upsample_int_bwd": upsample_int_backward,
            "upsample_sigmoid": upsample_sigmoid,
            "normalize_and_flip": normalize_and_flip,
            "channel_moments": channel_moments,
            "channel_dual_sums": channel_dual_sums,
            "bn_apply": bn_apply,
            "bn_input_gradient": bn_input_gradient,
            "dwconv_forward": dwconv_forward,
            "dwconv_input_grad": dwconv_input_grad,
            "dwconv_weight_grad": dwconv_weight_grad}
