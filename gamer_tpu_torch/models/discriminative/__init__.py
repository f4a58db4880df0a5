from gamer_tpu_torch.models.discriminative.base import (
    DIS_MODELS, DisModelConfig, dis_calculate_loss, full_sort_scores, sample_sort_scores)
from gamer_tpu_torch.models.discriminative import sasrec, gru4rec, bert4rec  # noqa: F401
from gamer_tpu_torch.models.discriminative import mbht, mbstr, pbat  # noqa: F401

__all__ = ["DIS_MODELS", "DisModelConfig", "dis_calculate_loss",
           "full_sort_scores", "sample_sort_scores"]
