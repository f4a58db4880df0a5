from gamer_tpu_torch.evaluation.ranking import hits_matrix, metrics_from_hits, rank_metrics

__all__ = ["hits_matrix", "metrics_from_hits", "rank_metrics"]
