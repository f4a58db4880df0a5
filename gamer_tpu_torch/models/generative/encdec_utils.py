"""Input preparation and loss of the enc-dec family (shared by the tasks).

PyTorch counterpart of `gamer_tpu/models/generative/encdec_utils.py`.
"""

from __future__ import annotations

import torch

from gamer_tpu_torch.core import distributed
from gamer_tpu_torch.core.device import to_device
from gamer_tpu_torch.models.generative.encdec import EncDecConfig, EncDecModel, shift_right
from gamer_tpu_torch.modules.losses import IGNORE_LABEL
from gamer_tpu_torch.ops import router as router_ops


def prepare_encdec_inputs(cfg: EncDecConfig, batch: dict) -> dict:
    """Model inputs of a batch of tensors: the encoder stream with its
    routing (PBATransformer's position-routed experts; harmless for TIGER,
    whose layers are dense), decoder inputs by `shift_right`, and the
    decoder routing by absolute decoder position."""
    enc_ids = batch["input_ids"]
    attn = batch["attention_mask"]
    rel = router_ops.rel_positions(attn)
    enc_pos, enc_beh, _ = router_ops.route_tokens(
        enc_ids, rel, cfg.num_positions, cfg.behavior_base, cfg.num_behavior)
    dec_in = shift_right(batch["labels"], cfg.decoder_start_token_id)
    dpos = torch.arange(dec_in.shape[1], dtype=torch.int32, device=dec_in.device)
    dec_pos = ((dpos % cfg.num_positions) + 1)[None].expand(dec_in.shape[0], -1)
    return dict(
        encoder_input_ids=enc_ids,
        encoder_attention_mask=attn,
        decoder_input_ids=dec_in,
        enc_position_index=enc_pos,
        enc_behavior_index=enc_beh,
        dec_position_index=dec_pos,
        dec_behavior_index=torch.zeros_like(dec_pos),
    )


def encdec_loss_fn(model: EncDecModel, cfg: EncDecConfig | None = None,
                   deterministic: bool = False):
    """loss_fn(batch, generator=None) -> (loss, {"denom": valid-target count}),
    in the convention of `tasks/train_smb_decoder.make_loss_fn`: the
    temperature-scaled CE where logits[t] predicts labels[t] (the decoder
    inputs are already shifted; ref TIGER/model.py:156-161), over targets
    != IGNORE_LABEL of rows with `row_valid`. `deterministic=False` is the
    training loss (dropout seeds from `generator`, a CPU `torch.Generator`;
    differentiable), `deterministic=True` the eval loss (dropout off, no
    grad). `batch` holds tensors or numpy arrays; they move to the model's
    device."""
    cfg = cfg or model.cfg

    def loss_fn(batch: dict, generator: torch.Generator | None = None):
        with torch.set_grad_enabled(not deterministic and torch.is_grad_enabled()):
            batch = {k: to_device(v, model.device) for k, v in batch.items()}
            # under a process group the dropout masks are the global batch's
            row0 = 0 if deterministic else distributed.first_row(batch["labels"].shape[0])
            out = model(**prepare_encdec_inputs(cfg, batch), deterministic=deterministic,
                        generator=generator, row0=row0)
            logits = out["logits"].float() / cfg.temperature
            labels = batch["labels"]
            valid = labels != IGNORE_LABEL
            if "row_valid" in batch:
                valid = valid & (batch["row_valid"][:, None] == 1)
            safe = torch.where(valid, labels, 0).long()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
            denom = valid.sum().clamp(min=1)
            return torch.where(valid, nll, 0.0).sum() / denom, {"denom": denom}

    return loss_fn
