"""tokenize — emit semantic-ID `.index.*.json` files.

The port's counterpart of `gamer_tpu/tasks/tokenize.py` (ref:
SeqRec/tasks/tokenize.py), with the same four tokenizers and output names:
  rq_vae     RQ-VAE checkpoint inference + collision repair
             -> <ds>.index.epoch<E>.alpha<A>-beta<B>.json (ref :219-222)
  rq_kmeans  iterated residual k-means (+ optional CF concat, --reduce PCA)
             -> <ds>.index.rq-kmeans[-cf].json (ref :171-178)
  cid        chunked base-k positional codes -> <ds>.index.cid[.shuffle].chunk<k>.json
  rid        random unique codes -> <ds>.index.rid.json

`rq_vae` reads the port's own checkpoint (`RQVAE`'s `config.json` and state
dict); a JAX checkpoint reaches the port only through `convert.py`.
Collision repair (ref reduce_collision :102-150): up to 10 rounds, each
re-assigning every group of items that share a full code by the
Sinkhorn-balanced assignment of the last level (earlier levels' sk_epsilon
forced to 0, the last forced on, ref :286-290), then, beyond the reference,
a unique nearest last-level code for each member of a group that remains,
and for `rq_vae`, where a prefix holds more items than the last level has
codes, the surplus members moved to the nearest second-to-last-level code
whose prefix has a free last-level code.
The models run on the task's device (`--device`); cid and rid are numpy.
"""

from __future__ import annotations

import json
import math
import os
from collections import defaultdict

import numpy as np
import torch

from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
from gamer_tpu_torch.ops.kmeans import kmeans, pairwise_sq_dists
from gamer_tpu_torch.ops.sinkhorn import balanced_assign
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device
from gamer_tpu_torch.tasks.rqvae import load_embeddings

logger = get_logger("tasks.tokenize")

PREFIX = [f"<{c}_{{}}>" for c in "abcdefgh"]  # ref tokenize.py:387


def codes_to_strings(codes: np.ndarray) -> list[list[str]]:
    return [[PREFIX[lvl].format(int(c)) for lvl, c in enumerate(row)] for row in codes]


def collision_groups(codes: np.ndarray) -> list[np.ndarray]:
    buckets: dict[bytes, list[int]] = defaultdict(list)
    for i, row in enumerate(codes):
        buckets[row.tobytes()].append(i)
    return [np.array(v) for v in buckets.values() if len(v) > 1]


@TASKS.register("tokenize")
class Tokenize(Task):
    name = "tokenize"
    help = "Emit semantic-ID index files (rq_vae | rq_kmeans | cid | rid)."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("tokenize")
        g.add_argument("--mode", type=str, default="rq_vae",
                       choices=["rq_vae", "rq_kmeans", "cid", "rid"])
        # reference mode surface: boolean selectors instead of --mode
        # (ref tokenize.py:48-52 --rq_kmeans, :79-83 --cid, :96-99 --rid)
        g.add_argument("--rq_kmeans", action="store_true",
                       help="alias of --mode rq_kmeans (ref flag)")
        g.add_argument("--cid", action="store_true", help="alias of --mode cid (ref flag)")
        g.add_argument("--rid", action="store_true", help="alias of --mode rid (ref flag)")
        g.add_argument("--emb_file", type=str, default=None)
        g.add_argument("--ckpt_path", "--root_path", type=str, default="./checkpoint")
        g.add_argument("--ckpt_tag", type=str, default="best_collision")
        g.add_argument("--checkpoint", type=str, default=None,
                       help="checkpoint FILE name, e.g. best_collision_model.pth"
                            " (ref tokenize.py:72-77); mapped onto --ckpt_tag")
        g.add_argument("--epoch", type=int, default=0, help="epoch label in output name")
        g.add_argument("--alpha", type=str, default="0.02")
        g.add_argument("--beta", type=str, default="0.0001")
        g.add_argument("--num_code_list", type=str, nargs="+", default="256,256,256",
                       help="comma list (ours) or space-separated ints (ref)")
        g.add_argument("--cf_emb_file", "--cf_emb", type=str, default=None)
        g.add_argument("--reduce", action="store_true",
                       help="PCA-reduce text embeddings to the CF dim before "
                            "concatenation (ref tokenize.py:166-169)")
        g.add_argument("--chunk_size", type=int, default=256)
        g.add_argument("--shuffle", action="store_true")
        g.add_argument("--n_items", type=int, default=0,
                       help="item count for cid/rid (default: from .item.json)")
        return parser

    def run(self, *, dataset, data_path, seed, mode, emb_file, ckpt_path,
            ckpt_tag, epoch, alpha, beta, num_code_list, cf_emb_file,
            chunk_size, shuffle, n_items, reduce=False, rq_kmeans=False,
            cid=False, rid=False, checkpoint=None, device="cuda", **_):
        # reference boolean selectors win over --mode's default
        for flag, m in ((rq_kmeans, "rq_kmeans"), (cid, "cid"), (rid, "rid")):
            if flag:
                mode = m
        if checkpoint:  # "best_collision_model.pth" -> tag "best_collision"
            ckpt_tag = checkpoint.removesuffix(".pth").removesuffix("_model")
        if isinstance(num_code_list, list):  # ref nargs form vs comma string
            codes_list = ([int(v) for v in num_code_list[0].split(",")]
                          if len(num_code_list) == 1 else [int(v) for v in num_code_list])
        else:
            codes_list = [int(v) for v in num_code_list.split(",")]
        files = DataFiles(data_path, dataset)
        np.random.seed(seed)
        if mode in ("cid", "rid"):
            n = n_items or len(files.load_item_meta())
            if mode == "cid":
                return self.run_cid(files, chunk_size, n, shuffle)
            return self.run_rid(files, codes_list, n)
        self.device = task_device(device)
        x = load_embeddings(emb_file or files.path(".emb-synthetic-td.npy"))
        if mode == "rq_kmeans":
            return self.run_rq_kmeans(files, x, codes_list, cf_emb_file, reduce)
        return self.run_rq_vae(files, x, ckpt_path, ckpt_tag, epoch, alpha, beta)

    # ---- RQ-VAE ------------------------------------------------------------

    def run_rq_vae(self, files, x, ckpt_path, ckpt_tag, epoch, alpha, beta):
        cfg = RQVAEConfig.from_file(ckpt_path)
        model = RQVAE(cfg, device=self.device)
        model.load_state_dict(CheckpointManager(ckpt_path).restore(ckpt_tag,
                                                                   map_location=self.device))
        xt = torch.as_tensor(x, device=self.device)
        codes = model.get_indices(xt).cpu().numpy()
        # the repair's assignment: sk off except the last level (ref :286-290)
        repair_eps = [0.0] * (cfg.num_levels - 1) + [cfg.sk_epsilons[-1] or 0.003]

        def regroup_repair(idx):
            return model.get_indices(xt[idx], use_sk=True, sk_epsilons=repair_eps).cpu().numpy()

        def last_scores(idx):
            return model.last_level_distances(xt[idx]).cpu().numpy()

        def prefix_scores(idx):
            return tuple(d.cpu().numpy() for d in model.prefix_distances(xt[idx]))

        codes = self._reduce_collision(codes, regroup_repair, last_scores,
                                       prefix_scores if cfg.num_levels > 1 else None)
        out_file = files.path(f".index.epoch{epoch}.alpha{alpha}-beta{beta}.json")
        return self._write(codes, out_file)

    # ---- RQ-KMeans (ref :152-207) ------------------------------------------

    def run_rq_kmeans(self, files, x, num_code_list, cf_emb_file, reduce=False):
        if cf_emb_file:
            cf = np.load(cf_emb_file).astype(np.float32)
            if len(cf) != len(x):
                raise ValueError(f"CF embedding rows {len(cf)} must match the {len(x)} items")
            if reduce:
                # PCA to the CF width before concatenation (ref :166-169)
                centered = x - x.mean(axis=0, keepdims=True)
                _, _, vt = np.linalg.svd(centered, full_matrices=False)
                x = centered @ vt[: cf.shape[1]].T
                logger.info("PCA-reduced embeddings to %s", x.shape)
            x = np.concatenate([x, cf], axis=1)
        R = torch.as_tensor(x.astype(np.float32), device=self.device)
        codes = np.zeros((len(x), len(num_code_list)), dtype=np.int64)
        for level, k in enumerate(num_code_list):
            # best of 4 seedings: one carries ~5% inertia variance from
            # seeding luck (tests/test_rqvae.py golden parity)
            centers, labels = kmeans(R, k, iters=50, seed=level, n_init=4)
            codes[:, level] = labels.cpu().numpy()
            R = R - centers[labels]
            logger.info("rq_kmeans level %d/%d done (k=%d)", level + 1, len(num_code_list), k)
        self._rq_kmeans_state = (R, centers)  # the final residual, the last level's centers

        def last_dists(idx):
            return pairwise_sq_dists(R[torch.as_tensor(idx, device=R.device)], centers)

        def reassign_last(idx):
            new = codes[idx].copy()
            new[:, -1] = balanced_assign(last_dists(idx), 0.003, 50).cpu().numpy()
            return new

        codes = self._reduce_collision(codes, reassign_last,
                                       lambda idx: last_dists(idx).cpu().numpy())
        suffix = ".index.rq-kmeans" + ("-cf" if cf_emb_file else "") + ".json"
        return self._write(codes, files.path(suffix))

    # ---- CID / RID (ref :312-359) ------------------------------------------

    def run_cid(self, files, chunk_size, n_item, shuffle):
        n_token, cap = 1, chunk_size
        while cap < n_item:
            n_token += 1
            cap *= chunk_size
        order = np.random.permutation(n_item) if shuffle else np.arange(n_item)
        codes = np.stack([(order // (chunk_size ** j)) % chunk_size
                          for j in range(n_token)], axis=1)
        name = f".index.cid{'.shuffle' if shuffle else ''}.chunk{chunk_size}.json"
        return self._write(codes, files.path(name))

    def run_rid(self, files, num_code_list, n_item):
        pick = np.random.choice(math.prod(num_code_list), size=n_item, replace=False)
        codes = np.zeros((n_item, len(num_code_list)), dtype=np.int64)
        for j, k in enumerate(num_code_list):
            codes[:, j] = pick % k
            pick //= k
        return self._write(codes, files.path(".index.rid.json"))

    # ---- shared ------------------------------------------------------------

    def _reduce_collision(self, codes, reassign_fn, scores_fn=None, prefix_scores_fn=None,
                          max_rounds: int = 10):
        """Sinkhorn repair rounds (ref :102-150), then — beyond the reference,
        which can stall on tied distances — a deterministic unique-assignment
        pass over the last level that guarantees zero collisions whenever the
        last-level capacity allows, and with `prefix_scores_fn` a pass that
        moves what is left of an over-full prefix to another prefix."""
        for round_i in range(max_rounds):
            groups = collision_groups(codes)
            if not groups:
                return codes
            logger.info("collision repair round %d: %d groups", round_i, len(groups))
            for idx in groups:
                codes[idx] = reassign_fn(idx)
        if scores_fn is not None:
            codes = self._force_unique_last_level(codes, scores_fn)
        if prefix_scores_fn is not None and collision_groups(codes):
            codes = self._reroute_full_prefixes(codes, prefix_scores_fn)
        return codes

    @staticmethod
    def _reroute_full_prefixes(codes, prefix_scores_fn):
        """Each member of a colliding group but its first (whose prefix has no
        free last-level code left) moves to the second-to-last-level code
        nearest to it whose prefix has a free last-level code, and takes the
        nearest free code there (`prefix_scores_fn(idx)`: the members'
        distances at the second-to-last level [g, n], and at the last level
        after each of those codes [g, n, m])."""
        used = defaultdict(set)
        for row in codes:
            used[row[:-1].tobytes()].add(int(row[-1]))
        for idx in collision_groups(codes):
            movers = idx[1:]
            d_mid, d_last = prefix_scores_fn(movers)
            for i, item in enumerate(movers):
                for mid in np.argsort(d_mid[i], kind="stable"):
                    prefix = codes[item, :-1].copy()
                    prefix[-1] = mid
                    taken = used[prefix.tobytes()]
                    free = [m for m in np.argsort(d_last[i, mid], kind="stable")
                            if int(m) not in taken]
                    if free:
                        codes[item, :-1], codes[item, -1] = prefix, free[0]
                        taken.add(int(free[0]))
                        break
        return codes

    @staticmethod
    def _force_unique_last_level(codes, scores_fn):
        """Within each colliding group, give members distinct nearest last-level
        codes, avoiding codes already used under the same prefix."""
        used = defaultdict(set)
        for row in codes:
            used[row[:-1].tobytes()].add(int(row[-1]))
        for _ in range(3):
            groups = collision_groups(codes)
            if not groups:
                break
            for idx in groups:
                d = np.asarray(scores_fn(idx))  # [g, K]
                for i in np.argsort(d.min(axis=1)):
                    item = idx[i]
                    prefix = codes[item, :-1].tobytes()
                    taken = used[prefix]
                    for code in np.argsort(d[i]):
                        if int(code) not in taken:
                            used[prefix].discard(int(codes[item, -1]))
                            codes[item, -1] = int(code)
                            used[prefix].add(int(code))
                            break
        return codes

    @staticmethod
    def _write(codes, out_file):
        strings = codes_to_strings(codes)
        d = {str(i): strings[i] for i in range(len(strings))}
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(d, f)
        coll = 1 - len({tuple(r) for r in codes.tolist()}) / len(codes)
        logger.info("wrote %s: %d items, collision rate %.4f", out_file, len(codes), coll)
        return {"output_file": out_file, "collision_rate": coll, "n_items": len(codes),
                "codes": codes}
