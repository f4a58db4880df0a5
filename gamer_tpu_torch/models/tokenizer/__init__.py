from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig

__all__ = ["RQVAE", "RQVAEConfig"]
