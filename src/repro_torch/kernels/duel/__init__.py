from repro_torch.kernels.duel.duel import (PROMOTE_CAP, DuelXs,
                                          duel_rearm_cuda, duel_rearm_ref,
                                          duel_scan_cuda, duel_steps_ref)

__all__ = ["PROMOTE_CAP", "DuelXs", "duel_rearm_cuda", "duel_rearm_ref",
           "duel_scan_cuda", "duel_steps_ref"]
