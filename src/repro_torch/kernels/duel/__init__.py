from repro_torch.kernels.duel.duel import DuelXs, duel_scan_cuda, duel_steps_ref

__all__ = ["DuelXs", "duel_scan_cuda", "duel_steps_ref"]
