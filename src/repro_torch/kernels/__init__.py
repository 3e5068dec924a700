"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``launch_counters()`` names each kernel's wrapper; every wrapper carries
a plain-integer ``launches`` count that it bumps where it launches its
kernel, and nowhere else.
"""


def launch_counters() -> dict:
    """Kernel name → its launching wrapper (whose ``launches`` counts)."""
    from repro_torch.kernels.duel.duel import (duel_rearm_cuda,
                                              duel_scan_cuda)
    from repro_torch.kernels.flash_attention.flash import flash_cuda
    from repro_torch.kernels.gain.gain import gain_cuda
    from repro_torch.kernels.knn.gains import gains_cuda
    from repro_torch.kernels.knn.knn import fused_lookup_cuda, knn_cuda
    return {"fused_lookup": fused_lookup_cuda, "knn": knn_cuda,
            "placement_gains": gains_cuda, "greedy_gain": gain_cuda,
            "flash_attention": flash_cuda, "duel_scan": duel_scan_cuda,
            "duel_rearm": duel_rearm_cuda}


def reset_launch_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}
