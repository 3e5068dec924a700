"""Analytic planes over a cache network. Counterpart of
``repro.core.analysis``: the Che hit-rate plane of :mod:`.hitrate`."""
from repro_torch.core.analysis.hitrate import (HitRatePrediction,
                                               SimilarityBalls,
                                               exact_hit_balls,
                                               predict_hitrates,
                                               rescaled_coords,
                                               similarity_balls,
                                               solve_characteristic_time,
                                               surrogate_cost)

__all__ = ["SimilarityBalls", "HitRatePrediction", "similarity_balls",
           "exact_hit_balls", "solve_characteristic_time",
           "predict_hitrates", "surrogate_cost", "rescaled_coords"]
