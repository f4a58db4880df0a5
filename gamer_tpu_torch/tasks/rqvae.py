"""RQVAE — train the RQ-VAE item tokenizer.

The port's counterpart of `gamer_tpu/tasks/rqvae.py` (ref:
SeqRec/tasks/RQVAE.py, SeqRec/trainers/RQVAE.py): trains on the item
embedding matrix with CF-embedding alignment, cascaded balanced-k-means
codebook init (`--kmeans_init`), re-clusters each codebook every
`--recluster_every` epochs for the diversity loss (ref trainers/RQVAE.py
:163-177), evaluates the emitted-code collision rate (ref :189-218), and
keeps the `best_loss`, `best_collision` and `last` checkpoints (state dicts,
`core/checkpoint.py`) plus `config.json` in `--output_dir`, which
`tokenize --mode rq_vae` reads. The result carries every epoch's means
of the loss and of its parts (recon, quant, cf) and its time, each eval's
collision rate, and the k-means init's cluster sizes and time. Batches are
row slices of one numpy permutation an epoch, wrapped around to whole batches; each step's
diversity positives come from a CPU `torch.Generator` seeded by (seed,
epoch, row offset), where the JAX package folds them into its rng key.
Plain PyTorch on the task's device (`--device`); one process. The
functions JAX jits, the training step, the emit and the reclustering
(`_balanced_impl` a level), are `RQVAEStep`, `RQVAEEmit` and
`RQVAERecluster`: the host stages row indices into the resident embeddings,
the step's draws and the reclustering's seeds into static device buffers,
and the device part is captured on the card as a CUDA graph and replayed;
a step's losses stay on the card until the epoch's end, and the
reclustering writes its labels straight into the step's diversity-label
buffer. The k-means init runs eagerly, once a level (its seeding drawn on
the device, `ops/kmeans.py`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.metrics import MetricWriter
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.core.graphs import StagedGraphs
from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig, rqvae_loss, training_draws
from gamer_tpu_torch.ops.kmeans import balanced_kmeans, codebook_labels
from gamer_tpu_torch.ops.seeds import U32, DeviceSeed
from gamer_tpu_torch.tasks.base import (
    Task, add_dataset_args, add_global_args, add_ref_compat_args, task_device)
from gamer_tpu_torch.train.staging import Staging
from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

logger = get_logger("tasks.rqvae")


def _load_tensor_file(path: str) -> np.ndarray:
    """Load a .npy or torch .pt/.pth tensor pickle as float32 numpy (the
    reference ships its CF embeddings as torch pickles, ref
    tasks/RQVAE.py:161-165)."""
    if path.endswith((".pt", ".pth")):
        t = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(t, dict):  # state-dict style: take the single tensor
            if len(t) != 1:
                raise ValueError(f"{path}: expected one tensor, got keys {list(t)}")
            t = next(iter(t.values()))
        return np.asarray(t.detach().to(torch.float32).numpy())
    return np.load(path).astype(np.float32)


def load_embeddings(path: str) -> np.ndarray:
    """ref datasets/emb_dataset.py:7-27 (std-normalize when too flat)."""
    emb = _load_tensor_file(path)
    std = emb.std()
    if std < 0.2:
        logger.warning("embedding std %.4f too low; normalizing", std)
        emb = emb / std
    return emb


@torch.no_grad()
def init_codebooks_from_data(model: RQVAE, x: torch.Tensor, seed: int = 0) -> list[np.ndarray]:
    """Cascaded balanced-k-means codebook init (ref
    ResidualVectorQuantizer.vq_ini, resiual_vector_quantizer.py:50-57 +
    vector_quantizer.py:44-47,90-125), in place. Returns each level's
    cluster sizes."""
    cfg = model.cfg
    residual = model.encoder(x)
    sizes = []
    for level, n_e in enumerate(cfg.num_emb_list):
        centers, labels = balanced_kmeans(residual, n_e, iters=cfg.kmeans_iters,
                                          seed=seed + level)
        model.codebooks[level, :n_e] = centers  # rows past n_e are never read
        model.codebooks[level, n_e:] = 0.0
        sizes.append(torch.bincount(labels, minlength=n_e).cpu().numpy())
        residual = residual - centers[labels]
    return sizes


def collision_rate(indices: np.ndarray) -> float:
    """ref trainers/RQVAE.py:189-218."""
    uniq = np.unique(indices.reshape(len(indices), -1), axis=0)
    return (len(indices) - len(uniq)) / len(indices)


def _step(model: RQVAE, optimizer, x: torch.Tensor, cf: torch.Tensor | None,
          diversity_labels: torch.Tensor | None, **forward) -> tuple[torch.Tensor, dict]:
    """Forward, backward and the optimizer's device half on batch `x`
    (BatchNorm's running statistics move in the forward); `forward` gives
    the forward its draws. Returns (loss, aux), detached."""
    cfg = model.cfg
    model.zero_grad(set_to_none=True)
    out = model(x, use_sk=True, deterministic=False,
                diversity_labels=diversity_labels if cfg.beta > 0 else None, **forward)
    loss, aux = rqvae_loss(cfg, out, x, cf)
    loss.backward()
    optimizer.apply({n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def train_step(model: RQVAE, optimizer, x: torch.Tensor, cf: torch.Tensor | None,
               diversity_labels: torch.Tensor | None, generator: torch.Generator,
               diversity_noise=None) -> tuple[torch.Tensor, dict]:
    """One optimizer step on batch `x`, its draws made from `generator`
    inside the forward; `diversity_noise` hands over the Gumbel noise of
    the diversity positives instead. Returns (loss, aux). The unstaged form
    of `RQVAEStep`, which equals it."""
    optimizer.prepare()
    return _step(model, optimizer, x, cf, diversity_labels, generator=generator,
                 diversity_noise=diversity_noise)


def step_generator(seed: int, epoch: int, row: int) -> torch.Generator:
    """The diversity-noise generator of the step at `row` of `epoch`."""
    return torch.Generator().manual_seed((seed * 1_000_003 + epoch * 100_003 + row) % 2 ** 63)


AUX = ("recon_loss", "quant_loss", "cf_loss")  # the parts of a step's loss, in `RQVAEStep`'s order


class RQVAEStep:
    """JAX's jitted `train_step` of the task in two parts. The host part
    (`stage`) writes the batch's row indices into the resident embeddings
    `x` (and CF embeddings `cf`), the forward's draws from the step's
    generator (`models/tokenizer/rqvae.training_draws`: the dropout seed
    table, then each level's Gumbel noise, as the unstaged forward draws
    them) and the optimizer's scalars into static device buffers. The
    device part (`device_part`) gathers the rows, then runs forward (BatchNorm's running
    statistics move there), backward and the optimizer's device half
    (kernel L on the card), and returns [loss, *AUX] on the device, read by
    the caller once an epoch. It reads the diversity labels from their own
    static buffer, rewritten at each recluster (`set_labels`). On the card
    it is captured once per batch geometry and replayed
    (`core/graphs.StagedGraphs`, "rq-vae training step"); `graphed=False`
    runs it eagerly. Either way it equals `train_step` with the same
    generator bit for bit."""

    def __init__(self, model: RQVAE, optimizer, x: torch.Tensor, cf: torch.Tensor | None = None,
                 graphed: bool = True):
        self.model, self.optimizer, self.x, self.cf = model, optimizer, x, cf
        c = model.cfg
        self.labels = torch.zeros((c.num_levels, max(c.num_emb_list)), dtype=torch.int64,
                                  device=x.device)
        self._labels_in = Staging({"labels": self.labels})
        self.staged = StagedGraphs(x.device, "rq-vae training step", graphed)

    def set_labels(self, labels) -> None:
        """The diversity clusters [levels, max codebook size], into their
        static buffer."""
        self._labels_in.write({"labels": labels})

    def stage(self, rows: np.ndarray, generator: torch.Generator) -> tuple[tuple, dict]:
        """The host part: (the key, {name: static device buffer})."""
        key, static = self.staged.stage({"rows": np.asarray(rows, np.int64),
                                         **training_draws(self.model, len(rows), generator)})
        self.optimizer.prepare()
        return key, static

    def device_part(self, static: dict) -> torch.Tensor:
        """One step on the staged rows and draws: [loss, *AUX]."""
        rows = static["rows"]
        noise = ([static[f"noise_{lvl}"] for lvl in range(self.model.cfg.num_levels)]
                 if "noise_0" in static else None)
        loss, aux = _step(self.model, self.optimizer, self.x[rows],
                          self.cf[rows] if self.cf is not None else None, self.labels,
                          diversity_noise=noise, seed_table=static.get("seeds"))
        return torch.stack([loss, *(aux[k] for k in AUX)])

    def __call__(self, rows: np.ndarray, generator: torch.Generator) -> torch.Tensor:
        """One optimizer step on rows `rows` of `x`: [loss, *AUX] on the
        device. A graph's update reads the optimizer's record table, kept
        with it."""
        key, static = self.stage(rows, generator)
        return self.staged.run(key, self.device_part, static,
                               hold=lambda: self.optimizer.last_table)


def train_epoch(step: RQVAEStep, order: np.ndarray, batch_size: int, seed: int,
                epoch: int) -> list:
    """The steps of one epoch over `order` (row indices, a whole number of
    batches): [[loss, *AUX] a step], read from the device once, at the end."""
    outs = [step(order[s:s + batch_size], step_generator(seed, epoch, s))
            for s in range(0, len(order), batch_size)]
    return torch.stack(outs).tolist()


class RQVAERecluster:
    """The per-epoch diversity reclustering (ref trainers/RQVAE.py:163-177):
    JAX's jitted `_balanced_impl` on each level's codebook, as one device
    function of every level. The host part (`stage`) writes each level's
    seed (seed + epoch + level, as the JAX task seeds `cluster_codebook`)
    into a static int32 buffer. The device part (`device_part`) runs, for
    each level, `ops/kmeans.codebook_labels` (balanced k-means) on the
    codebook's live rows with `min(n_clusters, codes)` clusters, seeded from
    that buffer (`ops/seeds.DeviceSeed`), and writes the labels into
    `labels` ([levels, max codebook size] int64, `RQVAEStep.labels`; the
    rows past a level's codes 0, as the task's padding), reading nothing
    into Python. On the card it is captured once per key (the codebook's
    shape and the clusters a level: one graph for all levels, replayed at
    every later reclustering; "rq-vae recluster"); `graphed=False` runs it
    eagerly. Either way the labels equal `cluster_codebook`'s a level."""

    def __init__(self, model: RQVAE, labels: torch.Tensor, graphed: bool = True):
        self.model, self.labels = model, labels
        c = model.cfg
        self.clusters = tuple(min(c.n_clusters, n) for n in c.num_emb_list)
        self.staged = StagedGraphs(labels.device, "rq-vae recluster", graphed)

    def stage(self, seed: int, epoch: int) -> tuple[tuple, dict]:
        """The host part: (the key, {"seeds": [levels] int32 buffer})."""
        seeds = np.array([(seed + epoch + lvl) & U32 for lvl in range(len(self.clusters))],
                         np.uint32).view(np.int32)
        key, static = self.staged.stage({"seeds": seeds})
        return key + (tuple(self.model.codebooks.shape), self.clusters), static

    @torch.no_grad()
    def device_part(self, static: dict) -> None:
        books = self.model.codebooks.detach()
        for lvl, (n, k) in enumerate(zip(self.model.cfg.num_emb_list, self.clusters)):
            self.labels[lvl, :n].copy_(codebook_labels(books[lvl, :n], k,
                                                       DeviceSeed(static["seeds"], lvl)))
            self.labels[lvl, n:].zero_()

    def __call__(self, seed: int, epoch: int) -> None:
        """Recluster every level's codebook for `epoch` into `labels`."""
        key, static = self.stage(seed, epoch)
        self.staged.run(key, self.device_part, static)


class RQVAEEmit:
    """JAX's jitted `emit_indices` over every item: the rows of `x` in
    chunks of `batch_size`, the last padded by wrapping to the first rows
    (JAX emits over the padded epoch order), each chunk's row indices
    staged and its codes (`RQVAE.get_indices`: greedy, BatchNorm on its
    running statistics) computed by one device part, captured on the card
    once ("rq-vae emit") and replayed; `graphed=False` runs it eagerly."""

    def __init__(self, model: RQVAE, x: torch.Tensor, batch_size: int, graphed: bool = True):
        self.model, self.x, self.batch_size = model, x, batch_size
        self.staged = StagedGraphs(x.device, "rq-vae emit", graphed)

    def device_part(self, static: dict) -> torch.Tensor:
        return self.model.get_indices(self.x[static["rows"]])

    def __call__(self) -> np.ndarray:
        """[n, levels] codes of the n rows of `x`, in row order."""
        n = len(self.x)
        pad_n = -(-n // self.batch_size) * self.batch_size
        rows = np.arange(pad_n, dtype=np.int64) % n
        out = []
        for s in range(0, pad_n, self.batch_size):
            key, static = self.staged.stage({"rows": rows[s:s + self.batch_size]})
            out.append(self.staged.run(key, self.device_part, static))
        return torch.cat(out).cpu().numpy()[:n]


@TASKS.register("RQVAE")
class TrainRQVAE(Task):
    name = "RQVAE"
    help = "Train the RQ-VAE semantic-ID tokenizer."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("rqvae")
        g.add_argument("--emb_file", type=str, default=None,
                       help="item embedding .npy (default <ds>.emb-synthetic-td.npy)")
        g.add_argument("--cf_emb_file", "--cf_emb", type=str, default=None,
                       help="CF embedding .npy/.pt for the alignment loss")
        g.add_argument("--epochs", type=int, default=2000)
        g.add_argument("--batch_size", type=int, default=1024)
        g.add_argument("--learning_rate", "--lr", type=float, default=1e-3)
        g.add_argument("--weight_decay", type=float, default=1e-4)
        g.add_argument("--eval_step", type=int, default=50)
        g.add_argument("--e_dim", type=int, default=32)
        g.add_argument("--num_emb", type=int, default=256)
        g.add_argument("--num_levels", type=int, default=4)
        g.add_argument("--num_emb_list", type=str, default=None,
                       help="per-level codebook sizes, comma list (ref "
                            "RQVAE.py:65-70); overrides --num_emb/--num_levels")
        g.add_argument("--layers", type=str, default="2048,1024,512,256,128,64")
        g.add_argument("--alpha", type=float, default=0.02)
        g.add_argument("--beta", type=float, default=0.0001)
        g.add_argument("--sk_epsilons", type=str, default=None,
                       help="per-level sinkhorn eps, comma list (default 0s + 0.003)")
        g.add_argument("--kmeans_init", action="store_true")
        g.add_argument("--kmeans_iters", type=int, default=100,
                       help="max kmeans iterations for codebook init")
        g.add_argument("--sk_iters", type=int, default=50, help="max sinkhorn iterations")
        g.add_argument("--n_clusters", type=int, default=10,
                       help="diversity-loss clusters per codebook")
        g.add_argument("--sample_strategy", type=str, default="all",
                       help="accepted for parity (unused in the reference too)")
        g.add_argument("--bn", action="store_true",
                       help="BatchNorm in the encoder/decoder MLPs")
        g.add_argument("--dropout_prob", type=float, default=0.0)
        g.add_argument("--loss_type", type=str, default="mse")
        g.add_argument("--quant_loss_weight", type=float, default=1.0)
        g.add_argument("--learner", "--optim", type=str, default="adamw",
                       help="optimizer family (ref RQVAE.py:39)")
        g.add_argument("--ckpt_dir", dest="output_dir", default=argparse.SUPPRESS,
                       help="alias of --output_dir (ref RQVAE.py:100)")
        add_ref_compat_args(parser, "num_workers")
        g.add_argument("--recluster_every", type=int, default=1,
                       help="epochs between diversity re-clustering")
        return parser

    def run(self, *, dataset, data_path, output_dir, seed, emb_file, cf_emb_file,
            epochs, batch_size, learning_rate, weight_decay, eval_step,
            e_dim, num_emb, num_levels, layers, alpha, beta, sk_epsilons,
            kmeans_init, dropout_prob, loss_type, quant_loss_weight,
            recluster_every, num_emb_list=None, kmeans_iters=100, sk_iters=50,
            n_clusters=10, sample_strategy="all", bn=False, learner="adamw",
            device="cuda", **_):
        dev = task_device(device)
        files = DataFiles(data_path, dataset)
        x_np = load_embeddings(emb_file or files.path(".emb-synthetic-td.npy"))
        n, in_dim = x_np.shape

        cf = None
        if alpha > 0 and cf_emb_file:
            cf = _load_tensor_file(cf_emb_file)
            if len(cf) != n:
                raise ValueError(f"CF embedding rows {len(cf)} must match the {n} items")
        elif alpha > 0:
            logger.warning("no --cf_emb_file given; disabling CF loss")
            alpha = 0.0

        if num_emb_list:
            emb_list = [int(v) for v in str(num_emb_list).split(",")]
            num_levels = len(emb_list)
        else:
            emb_list = [num_emb] * num_levels
        eps = ([float(v) for v in sk_epsilons.split(",")] if sk_epsilons
               else [0.0] * (num_levels - 1) + [0.003])
        cfg = RQVAEConfig(
            in_dim=in_dim, num_emb_list=emb_list, e_dim=e_dim,
            layers=[int(v) for v in layers.split(",")], dropout_prob=dropout_prob, bn=bn,
            loss_type=loss_type, quant_loss_weight=quant_loss_weight, sk_epsilons=eps,
            sk_iters=sk_iters, kmeans_iters=kmeans_iters, n_clusters=n_clusters,
            sample_strategy=sample_strategy, alpha=alpha, beta=beta)
        model = RQVAE(cfg, device=dev, seed=seed)
        x = torch.as_tensor(x_np, device=dev)
        cf_all = torch.as_tensor(cf, device=dev) if cf is not None else None
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

        t0 = time.perf_counter()
        init_sizes = init_codebooks_from_data(model, x, seed) if kmeans_init else None
        sync()
        init_s = time.perf_counter() - t0
        if init_sizes is not None:
            logger.info("k-means codebook init in %.1f s; cluster sizes min/max per level %s",
                        init_s, [(int(s.min()), int(s.max())) for s in init_sizes])

        optimizer = make_optimizer(OptimizerConfig(
            optim=learner, learning_rate=learning_rate, weight_decay=weight_decay,
            lr_scheduler_type="constant", warmup_ratio=0.0, max_grad_norm=0.0,
            total_steps=epochs * max(n // batch_size, 1)), model)

        ckpt = CheckpointManager(output_dir)
        writer = MetricWriter(os.path.join("runs", self.name),
                              config=getattr(self, "param_dict", {}))
        best_loss, best_collision = np.inf, np.inf
        np_rng = np.random.default_rng(seed)
        step = RQVAEStep(model, optimizer, x, cf_all)
        recluster = RQVAERecluster(model, step.labels)
        emit = RQVAEEmit(model, x, batch_size)
        pad_n = ((n + batch_size - 1) // batch_size) * batch_size
        history, epoch_s, epoch_means = [], [], []

        for epoch in range(epochs):
            t0 = time.perf_counter()
            if cfg.beta > 0 and epoch % recluster_every == 0:
                recluster(seed, epoch)
            order = np_rng.permutation(n)
            order = np.concatenate([order, order[:pad_n - n]])
            rows = train_epoch(step, order, batch_size, seed, epoch)
            # summed in step order: the floats of a read a step
            ep_loss, n_steps, parts = 0.0, len(rows), {k: 0.0 for k in AUX}
            for loss, *aux in rows:
                ep_loss += loss
                for k, v in zip(AUX, aux):
                    parts[k] += v
            ep_loss /= max(n_steps, 1)
            epoch_s.append(time.perf_counter() - t0)
            epoch_means.append({"loss": ep_loss, **{k: v / n_steps for k, v in parts.items()}})
            if not np.isfinite(ep_loss):
                raise ValueError("Training loss is nan")

            if (epoch + 1) % eval_step == 0 or epoch == epochs - 1:
                coll = collision_rate(emit())
                history.append({"epoch": epoch, "collision_rate": coll, **epoch_means[-1]})
                writer.log({"train/loss": ep_loss, "eval/collision_rate": coll}, step=epoch)
                logger.info("epoch %d: loss %.4f collision %.4f", epoch, ep_loss, coll)
                if ep_loss < best_loss:
                    best_loss = ep_loss
                    ckpt.save("best_loss", model.state_dict(), {"epoch": epoch, "loss": ep_loss})
                if coll < best_collision:
                    best_collision = coll
                    ckpt.save("best_collision", model.state_dict(),
                              {"epoch": epoch, "collision_rate": coll})
        ckpt.save("last", model.state_dict(), {"epoch": epochs - 1})
        cfg.save(output_dir)
        logger.info("done: best loss %.4f best collision %.4f", best_loss, best_collision)
        return {"best_loss": float(best_loss), "best_collision": float(best_collision),
                "history": history, "epochs": epoch_means, "init_s": init_s, "epoch_s": epoch_s,
                "init_cluster_sizes": None if init_sizes is None else
                [s.tolist() for s in init_sizes]}
