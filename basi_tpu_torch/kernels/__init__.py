"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""


def launch_counters() -> dict:
    """Each kernel wrapper of the port by name; each carries ``launches``,
    the count of its kernel's launches."""
    from basi_tpu_torch.kernels.bn_stats import (
        channel_dual_sums,
        channel_moments,
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
            "channel_dual_sums": channel_dual_sums}
