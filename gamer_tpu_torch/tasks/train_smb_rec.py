"""train_SMB_rec — discriminative SMB training + per-behavior full-sort eval.

The port's counterpart of `gamer_tpu/tasks/train_smb_rec.py` (ref:
SeqRec/tasks/train_SMB_rec.py, SeqRec/trainers/SMBRec.py): builds the
backbone from the discriminative zoo (`models/discriminative`), trains with
CE/BPR (or the model's own masked objective), evaluates by ranking the
held-out-session targets against the full item table per behavior,
early-stops on the main metric, keeps the `best` checkpoint (a state dict,
`core/checkpoint.py`) and `config.json` in `--output_dir`, and reports
hit/recall/ndcg with the reference's multi-target normalization (ref
SMBRec.py:96-143) into `<result_dir>/<dataset>_<backbone>.json`.

Task-string variants (ref loading_SMB_dis.py): smb_dis[_diff][_target][_neg]
[_uid] — diff = behavior-disambiguated item ids, target = history includes
the target event, neg = BPR negative sampling, uid = user ids (PBAT).

Each training step draws its masked-LM positions and its hash-dropout
seeds from a CPU `torch.Generator` seeded by (seed, epoch * 10007 + batch
offset) (`step_generator`), where the JAX task folds the same number into
its rng key. Plain PyTorch on the task's device (`--device`), fp32, one
process: the JAX task does not shard either; the dropout runs on kernels
K1/K2 and the update on kernel L on the card. The two functions JAX jits,
the training step and the scorer, are `RecTrainStep` and `RecScorer`: a
host part that stages the batch and the step's draws into static device
buffers (no pageable copy in the loop), and a device part captured on the
card as a CUDA graph once per batch geometry and replayed. The result
carries the JAX task's keys and the per-step losses.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.core.graphs import StagedGraphs
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.metrics import MetricWriter
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.smb import SMBCorpus
from gamer_tpu_torch.data.smb_dis import DisBatcher, SMBDisBuilder
from gamer_tpu_torch.models.discriminative import DIS_MODELS, DisModelConfig, dis_calculate_loss
from gamer_tpu_torch.models.discriminative.base import draw_uniforms, training_draws
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device
from gamer_tpu_torch.train.staging import as_array
from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

logger = get_logger("tasks.train_smb_rec")

MASKED_MODELS = {"BERT4Rec", "MBHT", "MBSTR", "PBAT"}  # eval via appended mask slot


def dis_eval_metrics(ranks: np.ndarray, n_targets: np.ndarray, metrics) -> dict[str, float]:
    """ref SMBRec.py:112-136 — metric sums over the batch from target ranks."""
    out = {m: 0.0 for m in metrics}
    B, T = ranks.shape
    for m in metrics:
        name, k = m.split("@")
        k = int(k)
        for i in range(B):
            n = int(n_targets[i])
            r = ranks[i, :n]
            if name == "hit":
                out[m] += float((r < k).any())
            elif name == "recall":
                out[m] += float((r < k).mean()) if n else 0.0
            elif name == "ndcg":
                dcg = float((1.0 / np.log2(r[r < k] + 2)).sum())
                idcg = float((1.0 / np.log2(np.arange(min(n, k)) + 2)).sum())
                out[m] += dcg / idcg if idcg > 0 else 0.0
            else:
                raise ValueError(m)
    return out


def build_dis_model(backbone: str, cfg: DisModelConfig, n_items: int, max_his_len: int,
                    n_behaviors: int, n_users: int, device=None, seed: int = 0):
    cls = DIS_MODELS.get(backbone)
    if backbone == "PBAT":
        return cls(cfg, n_items, max_his_len, n_users=n_users, device=device, seed=seed)
    if backbone == "MBHT":
        return cls(cfg, n_items, max_his_len, n_behaviors=n_behaviors, device=device, seed=seed)
    return cls(cfg, n_items, max_his_len, device=device, seed=seed)


def make_dis_loss_fn(backbone: str, model, cfg: DisModelConfig) -> Callable:
    """loss_fn(batch, generator, uniforms=None) -> scalar training loss;
    `batch` holds the collated tensors on the model's device, `generator`
    the CPU generator of the forward's draws or its seed table on the
    device, `uniforms` the masked-LM draws (the models' `calculate_loss`;
    needed with a seed table)."""

    def loss_fn(batch, generator: Optional[torch.Generator], uniforms=None):
        rv = batch.get("row_valid")
        if backbone in ("SASRec", "GRU4Rec"):
            return dis_calculate_loss(model, batch, generator, cfg.loss_type, model.n_items)
        if backbone == "BERT4Rec":
            return model.calculate_loss(batch["inputs"], batch["seq_len"], generator, rv, uniforms)
        if backbone == "MBSTR":
            return model.calculate_loss(batch["inputs"], batch["behaviors"], generator, rv,
                                        uniforms)
        if backbone == "PBAT":
            return model.calculate_loss(batch["inputs"], batch["behaviors"], batch["uid"],
                                        generator, rv, uniforms)
        if backbone == "MBHT":
            return model.calculate_loss(batch["inputs"], batch["behaviors"], batch["target"],
                                        batch["behavior"] + 1, batch["seq_len"], generator, rv,
                                        uniforms)
        raise NotImplementedError(backbone)

    return loss_fn


def make_score_fn(backbone: str, model) -> Callable:
    """Full-sort scorer: batch -> [B, n_items+1] (deterministic)."""

    @torch.no_grad()
    def score(batch):
        if backbone in ("SASRec", "GRU4Rec"):
            seq_out, table = model.encode_with_table(batch["inputs"], batch["seq_len"])
            return seq_out @ table.T
        if backbone == "BERT4Rec":
            return model.predict_scores(batch["inputs"], batch["seq_len"])
        if backbone in ("MBSTR", "MBHT"):
            return model.predict_scores(batch["inputs"], batch["behaviors"], batch["seq_len"])
        if backbone == "PBAT":
            return model.predict_scores(batch["inputs"], batch["behaviors"], batch["uid"],
                                        batch["seq_len"])
        raise NotImplementedError(backbone)

    return score


def rank_targets(scores: np.ndarray, targets_padded: np.ndarray,
                 item_range=None, candidates=None) -> np.ndarray:
    """rank of each padded target under a deterministic stable tie policy
    (index order, consistent with a stable argsort of -scores): rank =
    #strictly-higher + #equal-with-smaller-index. The reference's
    `np.argsort(-scores)` (ref train_SMB_rec.py:120) defaults to quicksort,
    so its tie order among EQUAL scores is implementation-defined — this is
    a sound deterministic choice, not bit-parity. A strict `>` alone gives
    every member of a tie the BEST rank — a degenerate constant/NaN scorer
    then reports hit=1.0 and ndcg>1 (observed when PBAT trained to NaN).
    Non-finite scores are treated as -inf so a broken model ranks last.

    With `candidates` [B, C] (sampled eval, ref SMBDisNegSampleEvalDataset)
    the rank is computed within a pool of exactly C entries: the valid
    targets followed by the first C - n_targets negatives — the reference
    collator truncates `(target_item + neg_item)[:num_neg]`
    (ref datasets/collator_traditional.py:30-31), dropping the last
    len(targets) negatives."""
    scores = np.where(np.isfinite(scores), scores, -np.inf)
    tgt_scores = np.take_along_axis(scores, targets_padded, axis=1)  # [B, T]
    if candidates is not None:
        n_targets = candidates["n_targets"]
        cand = candidates["all_item"]
        cand_scores = np.take_along_axis(scores, cand, axis=1)  # [B, C]
        # reference pool truncation: keep only the first C - n_targets
        # negatives so the pool stays at C entries total
        c_valid = (np.arange(cand.shape[1])[None]
                   < cand.shape[1] - n_targets[:, None])
        cand_scores = np.where(c_valid, cand_scores, -np.inf)
        # padded target slots must not pollute the pool
        t_valid = np.arange(targets_padded.shape[1])[None] < n_targets[:, None]
        pool = np.concatenate(
            [np.where(t_valid, tgt_scores, -np.inf), cand_scores], axis=1)
        higher = (pool[:, None, :] > tgt_scores[:, :, None]).sum(-1)
        # target j sits at pool position j; equal scores at earlier pool
        # positions sort ahead of it under stable argsort
        pos = np.arange(pool.shape[1])[None, None, :]
        tpos = np.arange(targets_padded.shape[1])[None, :, None]
        ties = ((pool[:, None, :] == tgt_scores[:, :, None])
                & (pos < tpos)).sum(-1)
        return higher + ties
    if item_range is not None:
        lo, hi = item_range
        valid = (np.arange(scores.shape[1]) >= lo) & (np.arange(scores.shape[1]) < hi)
        scores = np.where(valid[None], scores, -np.inf)
    higher = (scores[:, None, :] > tgt_scores[:, :, None]).sum(-1)
    ids = np.arange(scores.shape[1])[None, None, :]
    ties = ((scores[:, None, :] == tgt_scores[:, :, None])
            & (ids < targets_padded[:, :, None])).sum(-1)
    return higher + ties


def step_generator(seed: int, key: int) -> torch.Generator:
    """The CPU generator of the training step keyed `key` (epoch * 10007 +
    batch offset): its masked-LM draws and dropout seeds."""
    return torch.Generator().manual_seed((seed * 1_000_003 + key) % 2 ** 63)


def train_step(model, optimizer, loss_fn: Callable, batch: dict,
               generator: torch.Generator, uniforms=None) -> torch.Tensor:
    """One optimizer step on a batch of device tensors, its draws made from
    `generator` inside the forward; returns the loss (a detached device
    tensor). The unstaged form of `RecTrainStep`, which equals it."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(batch, generator, uniforms)
    loss.backward()
    optimizer.step({n: p.grad if p.grad is not None else torch.zeros_like(p)
                    for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return loss.detach()


class RecTrainStep:
    """JAX's jitted training step of the task (`train_step` in
    `gamer_tpu/tasks/train_smb_rec.py`) in two parts, as `train/loop.Trainer`
    splits its step. The host part (`stage`) writes the collated batch, the
    forward's draws from the step's generator (`training_draws`: the
    masked-LM uniforms, then the dropout seed table, in the order the
    unstaged forward draws them) and the optimizer's scalars
    (`Optimizer.prepare`) into static device buffers. The device part
    (`device_part`) is the forward, the backward and the optimizer's device
    half (kernel L on the card) on those buffers; it reads nothing into
    Python and copies nothing from the host. On the card it is captured once
    per batch geometry and replayed (`core/graphs.StagedGraphs`, "rec
    training step"); `graphed=False` runs it eagerly. Either way it equals
    `train_step` with the same generator bit for bit: the same draws, and
    the same kernels in the same order."""

    def __init__(self, backbone: str, model, cfg: DisModelConfig, optimizer,
                 graphed: bool = True):
        self.model, self.optimizer = model, optimizer
        self.loss_fn = make_dis_loss_fn(backbone, model, cfg)
        self.staged = StagedGraphs(optimizer.scalars.device, "rec training step", graphed)

    def stage(self, batch: dict, generator: torch.Generator) -> tuple[tuple, dict]:
        """The host part: (the key, {name: static device buffer})."""
        B, L = np.shape(batch["inputs"])
        key, static = self.staged.stage({**{n: as_array(v) for n, v in batch.items()},
                                         **training_draws(self.model, B, L, generator)})
        self.optimizer.prepare()
        return key, static

    def device_part(self, static: dict) -> torch.Tensor:
        """Forward, backward and update on the staged buffers; the loss."""
        self.model.zero_grad(set_to_none=True)
        loss = self.loss_fn(static, static["seeds"], draw_uniforms(static))
        loss.backward()
        self.optimizer.apply({n: p.grad if p.grad is not None else torch.zeros_like(p)
                              for n, p in self.model.named_parameters()})
        self.model.zero_grad(set_to_none=True)
        return loss.detach()

    def __call__(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        """One optimizer step; the loss, a detached device tensor. A graph's
        update reads the optimizer's record table, kept with it."""
        key, static = self.stage(batch, generator)
        return self.staged.run(key, self.device_part, static,
                               hold=lambda: self.optimizer.last_table)


# the batch arrays each backbone's scorer reads
SCORE_INPUTS = {"SASRec": ("inputs", "seq_len"), "GRU4Rec": ("inputs", "seq_len"),
                "BERT4Rec": ("inputs", "seq_len"), "MBSTR": ("inputs", "behaviors", "seq_len"),
                "MBHT": ("inputs", "behaviors", "seq_len"),
                "PBAT": ("inputs", "behaviors", "uid", "seq_len")}


class RecScorer:
    """JAX's jitted full-sort scorer (`make_score_fn`) in two parts: the
    host part stages the arrays of an eval batch that the backbone reads
    (`SCORE_INPUTS`) and, for the sampled eval, its `all_item`, which JAX's
    trace is keyed on too; the device part scores them (`make_score_fn`).
    The task pads every eval chunk to the eval batch size, as JAX does, so
    the card captures one graph per key ("rec scorer") and replays it;
    `graphed=False` scores eagerly. The ranking stays on the host."""

    def __init__(self, backbone: str, model, device, graphed: bool = True):
        self.score_fn = make_score_fn(backbone, model)
        self.names = SCORE_INPUTS[backbone]
        self.staged = StagedGraphs(device, "rec scorer", graphed)

    def __call__(self, batch: dict) -> torch.Tensor:
        """[B, n_items + 1] scores, on the device."""
        names = self.names + (("all_item",) if "all_item" in batch else ())
        key, static = self.staged.stage({n: as_array(batch[n]) for n in names})
        return self.staged.run(key, self.score_fn, static)


@TASKS.register("train_SMB_rec")
class TrainSMBRec(Task):
    name = "train_SMB_rec"
    help = "Train/evaluate a discriminative SMB recommender."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("training")
        g.add_argument("--epochs", type=int, default=100)
        g.add_argument("--batch_size", type=int, default=256)
        g.add_argument("--learning_rate", "--lr", type=float, default=1e-3)
        g.add_argument("--weight_decay", type=float, default=0.0)
        g.add_argument("--patience", type=int, default=10)
        g.add_argument("--metrics", type=str,
                       default="hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10")
        g.add_argument("--main_metric", type=str, default="ndcg@10")
        g.add_argument("--result_dir", type=str, default="./results")
        g.add_argument("--only_test", action="store_true")
        g.add_argument("--eval_batch_size", type=int, default=128)
        g.add_argument("--add_uid", action="store_true",
                       help="add user ids to the examples (ref train_SMB_rec.py:46; "
                            "PBAT and *_uid task strings imply it)")
        g.add_argument("--optim", type=str, default="adamw",
                       help="adam|sgd|adagrad|rmsprop|adamw (ref SMBRec.py:46-76)")
        g.add_argument("--test_task", type=str, default=None,
                       help="eval task string (ref train_SMB_rec.py:84); "
                            "default: derive the eval variant from --tasks")
        g.add_argument("--logging_step", type=int, default=0,
                       help="log running train loss every N steps (ref :69)")
        g.add_argument("--wandb_run_name", type=str, default=None,
                       help="run name in the metric stream (ref wandb name)")
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, tasks, backbone,
            base_model, output_dir, seed, epochs, batch_size, learning_rate,
            weight_decay, patience, metrics, main_metric, result_dir, only_test,
            eval_batch_size, add_uid=False, optim="adamw", test_task=None,
            logging_step=0, wandb_run_name=None, device="cuda", **_):
        dev = task_device(device)
        corpus = SMBCorpus(DataFiles(data_path, dataset), index_file)
        # task grammar (ref loading_SMB_dis.py:18-175):
        # smb_dis[_sample][_diff][_target|_neg|_decoder][_uid]
        task_parts = set(tasks.lower().split("_"))
        builder = SMBDisBuilder(corpus, max_his_len, diff="diff" in task_parts,
                                add_uid=add_uid or (backbone == "PBAT")
                                or "uid" in task_parts)
        if "decoder" in task_parts:
            variant = "user"
        elif "neg" in task_parts:
            variant = "neg"
        elif "target" in task_parts:
            variant = "target"
        else:
            variant = "base"
        train = builder.build_train(variant, seed)
        # MBHT trains only on target-behavior examples (ref train_SMB_rec.py:240-241)
        if backbone == "MBHT":
            train = [e for e in train
                     if int(e.target_behaviors[0]) == corpus.target_behavior_idx]
        masked = backbone in MASKED_MODELS
        # eval variant: --test_task overrides the train task string (ref :84)
        eval_parts = set(test_task.lower().split("_")) if test_task else task_parts
        num_neg = 1000 if "sample" in eval_parts else 0
        valid = builder.build_eval("valid", append_mask_slot=masked, num_neg=num_neg)
        test = builder.build_eval("test", append_mask_slot=masked, num_neg=num_neg)
        metric_list = metrics.split(",")

        cfg = DisModelConfig.from_file(base_model) if base_model else DisModelConfig()
        cfg = cfg.replace(n_behaviors=len(corpus.behavior_names))
        if backbone == "MBHT":
            # full fixed length incl. the target/mask slot; scales must divide
            L = max_his_len + 1
            s = list(cfg.scales)
            if L % s[1] != 0 or L % s[2] != 0:
                s[1] = next(v for v in range(s[1], 0, -1) if L % v == 0)
                s[2] = next(v for v in range(s[2], 0, -1) if L % v == 0)
                logger.warning("MBHT scales adjusted to %s for length %d", s, L)
                cfg = cfg.replace(scales=s)
            batch_len = L
        else:
            batch_len = max_his_len
        model = build_dis_model(backbone, cfg, builder.num_items, batch_len,
                                len(corpus.behavior_names), len(corpus.users), dev, seed)
        batcher = DisBatcher.for_examples(train + valid + test, seq_len=batch_len)
        scorer = RecScorer(backbone, model, dev)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("%s parameters: %.2fM", backbone, n_params / 1e6)

        optimizer = make_optimizer(OptimizerConfig(
            optim=optim, learning_rate=learning_rate, weight_decay=weight_decay,
            lr_scheduler_type="constant", warmup_ratio=0.0, max_grad_norm=0.0,
            total_steps=epochs * max(len(train) // batch_size, 1)), model)
        step = RecTrainStep(backbone, model, cfg, optimizer)

        def evaluate(examples, behavior_filter=None):
            sums = {m: 0.0 for m in metric_list}
            count = 0
            exs = examples
            if behavior_filter is not None:
                exs = builder.filter_by_behavior(examples, behavior_filter)
            if not exs:
                return sums, 0
            eb = DisBatcher.for_examples(exs, seq_len=batch_len)
            for s in range(0, len(exs), eval_batch_size):
                chunk = exs[s:s + eval_batch_size]
                n_real = len(chunk)
                if n_real < eval_batch_size:
                    chunk = list(chunk) + [chunk[0]] * (eval_batch_size - n_real)
                batch = eb.collate(chunk)
                scores = scorer(batch)[:n_real].cpu().numpy()
                if not np.isfinite(scores).all() and not getattr(
                        self, "_warned_nonfinite", False):
                    self._warned_nonfinite = True
                    logger.warning(
                        "non-finite eval scores (model diverged?) — they rank "
                        "LAST; check the train loss")
                cands = None
                if "all_item" in batch:
                    cands = {"all_item": batch["all_item"][:n_real],
                             "n_targets": batch["n_targets"][:n_real]}
                ranks = rank_targets(scores, batch["targets_padded"][:n_real],
                                     chunk[0].item_range, cands)
                for m, v in dis_eval_metrics(ranks, batch["n_targets"][:n_real],
                                             metric_list).items():
                    sums[m] += v
                count += n_real
            return sums, count

        writer = MetricWriter(os.path.join("runs", self.name), run_name=wandb_run_name,
                              config=getattr(self, "param_dict", {}))
        ckpt = CheckpointManager(output_dir)
        best = -np.inf
        evals_since_best = 0
        step_losses: list[float] = []
        if not only_test:
            np_rng = np.random.default_rng(seed)
            for epoch in range(epochs):
                order = np_rng.permutation(len(train))
                losses = []
                for s in range(0, len(order) - batch_size + 1, batch_size):
                    idx = order[s:s + batch_size]
                    losses.append(step(batcher.collate([train[j] for j in idx]),
                                       step_generator(seed, epoch * 10007 + s)))
                    if logging_step and len(losses) % logging_step == 0:
                        logger.info("epoch %d step %d: loss %.4f", epoch, len(losses),
                                    float(torch.stack(losses[-logging_step:]).mean()))
                losses = [float(v) for v in losses]  # one device sync an epoch
                step_losses.extend(losses)
                sums, count = evaluate(valid, behavior_filter=corpus.target_behavior_idx)
                metric = sums.get(main_metric, 0.0) / max(count, 1)
                mean_loss = float(np.mean(losses)) if losses else 0.0
                writer.log({"train/loss": mean_loss, f"eval/{main_metric}": metric}, step=epoch)
                logger.info("epoch %d: loss %.4f %s %.4f (best %.4f)", epoch, mean_loss,
                            main_metric, metric, best)
                if metric > best:
                    best = metric
                    evals_since_best = 0
                    ckpt.save("best", model.state_dict(), {"epoch": epoch, main_metric: metric})
                else:
                    evals_since_best += 1
                    if patience > 0 and evals_since_best >= patience:
                        logger.info("early stopping at epoch %d", epoch)
                        break
            cfg.save(output_dir)
        if ckpt.exists("best"):
            model.load_state_dict(ckpt.restore("best"))

        # per-behavior test (ref train_SMB_rec.py:296-335)
        results = {}
        for b, name in enumerate(corpus.behavior_names):
            sums, count = evaluate(test, behavior_filter=b)
            results[name] = {m: v / max(count, 1) for m, v in sums.items()}
            results[name]["count"] = count
            logger.info("test %s: %s", name,
                        {k: round(v, 4) for k, v in results[name].items()})
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, f"{dataset}_{backbone}.json"), "w") as f:
            json.dump(results, f, indent=2)
        return {"best_valid": float(best), "test": results, "losses": step_losses}
