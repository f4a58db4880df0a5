"""SemEmb — item metadata -> text -> PLM embeddings -> `.emb-<plm>-td.npy`.

The port's counterpart of `gamer_tpu/tasks/semantic_emb.py` (ref:
SeqRec/tasks/semantic_emb.py): per-dataset text templates (Amazon
title+description :73-83, KuaiRec Chinese prompt :85-105, Tmall cleaned title
:107-122), mean-pooled transformer embeddings with attention masking
(:168-189), averaged over text fields (:196-200), saved as
`<ds>.emb-<plm>-td.npy`.

Backends:
  transformers — AutoModel mean pooling on the task's device, only from a
                 local checkpoint directory (`local_files_only`: nothing is
                 fetched); `transformers` is imported only then
  hash         — deterministic feature-hashing embedding (word and bigram
                 projections), byte-identical with the JAX package's; used
                 whenever no local checkpoint is given
"""

from __future__ import annotations

import hashlib
import os
import re
import string

import numpy as np
import torch

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.tasks.base import (
    Task, add_dataset_args, add_global_args, add_ref_compat_args, task_device)

logger = get_logger("tasks.semantic_emb")


def clean_text(value) -> str:
    """ref utils/text.py behavior: flatten lists, strip html-ish noise."""
    if isinstance(value, list):
        value = " ".join(str(v) for v in value)
    text = re.sub(r"<[^>]+>", " ", str(value))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def item_texts(item2feature: dict, dataset: str) -> list[list[str]]:
    """Per-dataset templates (ref :73-133). Unknown datasets concatenate all
    string-valued metadata fields (generalization of the amazon template)."""
    out = []
    if dataset in ("Instruments", "Beauty", "Yelp"):
        keys = ["title", "description"]
        for item, data in item2feature.items():
            out.append([clean_text(data[k]).strip() for k in keys if k in data])
    elif dataset in ("Tmall", "Tmall-24-0.25"):
        for item, data in item2feature.items():
            t = re.sub(r"[{}]".format(re.escape(string.punctuation)), "", data.get("title", ""))
            t = re.sub(r"\d{6,}", "", t)
            out.append([" ".join(p for p in t.split(" ") if p)])
    else:
        for item, data in item2feature.items():
            fields = [clean_text(v) for v in data.values() if isinstance(v, (str, list))]
            out.append([" ".join(fields) if fields else f"item {item}"])
    # guarantee at least one non-empty text per item
    return [[t for t in texts if t] or ["unknown"] for texts in out]


def hash_embed(texts: list[str], dim: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic feature-hashing embedding: each word/bigram hashes to a
    signed coordinate; rows are L2-normalized. Similar texts -> similar rows."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, text in enumerate(texts):
        words = text.lower().split()
        grams = words + [" ".join(p) for p in zip(words, words[1:])]
        for g in grams:
            h = hashlib.md5(f"{seed}:{g}".encode()).digest()
            idx = int.from_bytes(h[:4], "little") % dim
            sign = 1.0 if h[4] % 2 == 0 else -1.0
            out[i, idx] += sign
        n = np.linalg.norm(out[i])
        if n > 0:
            out[i] /= n
    return out


@torch.no_grad()
def transformer_embed(texts: list[str], checkpoint: str, max_sent_len: int,
                      device: torch.device, batch_size: int = 32) -> np.ndarray:
    """Masked mean-pooled AutoModel embeddings (ref :152-191) of a local
    checkpoint directory, on `device`."""
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(checkpoint, use_fast=True, local_files_only=True)
    model = AutoModel.from_pretrained(checkpoint, local_files_only=True).to(device).eval()
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token_id = 0
    chunks = []
    for s in range(0, len(texts), batch_size):
        enc = tokenizer(texts[s:s + batch_size], max_length=max_sent_len, truncation=True,
                        return_tensors="pt", padding="longest").to(device)
        out = model(input_ids=enc.input_ids, attention_mask=enc.attention_mask)
        masked = out.last_hidden_state * enc.attention_mask.unsqueeze(-1)
        mean = masked.sum(dim=1) / enc.attention_mask.sum(dim=-1, keepdim=True)
        chunks.append(mean.float().cpu().numpy())
    return np.concatenate(chunks).astype(np.float32)


@TASKS.register("SemEmb")
class SemEmb(Task):
    name = "SemEmb"
    help = "Generate item semantic embeddings from metadata text."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        add_ref_compat_args(parser, "gpu_id", "root")
        g = parser.add_argument_group("sememb")
        g.add_argument("--plm_name", type=str, default="hash")
        g.add_argument("--plm_checkpoint", type=str, default=None,
                       help="local transformer checkpoint dir (omit for hash backend)")
        g.add_argument("--max_sent_len", type=int, default=2048)
        g.add_argument("--emb_dim", type=int, default=256, help="hash backend dim")
        g.add_argument("--data_type", type=str, default="SMB", choices=["SMB", "MB", "single"])
        return parser

    def run(self, *, dataset, data_path, seed, plm_name, plm_checkpoint,
            max_sent_len, emb_dim, data_type, device="cuda", **_):
        files = DataFiles(data_path, dataset)
        # items sorted by integer id so rows align with the code tables
        item2feature = dict(sorted(files.load_item_meta().items(), key=lambda kv: int(kv[0])))
        texts = item_texts(item2feature, dataset)
        n_item = len(texts)
        n_text = max(len(t) for t in texts)
        flat = [t[i] if i < len(t) else "" for t in texts for i in range(n_text)]

        if plm_checkpoint and os.path.isdir(plm_checkpoint):
            emb = transformer_embed(flat, plm_checkpoint, max_sent_len, task_device(device))
        else:
            if plm_checkpoint:
                logger.warning("checkpoint %s not found locally; using hash backend",
                               plm_checkpoint)
            emb = hash_embed(flat, dim=emb_dim, seed=seed)
        emb = emb.reshape(n_item, n_text, -1).mean(axis=1)  # avg text fields (ref :196)
        path = files.save_embeddings(emb, plm=plm_name)
        logger.info("saved %s: shape %s", path, emb.shape)
        return {"output_file": path, "shape": list(emb.shape)}
