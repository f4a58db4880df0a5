"""Where a training step of the port stops being bit-reproducible on the card.

    python3 scripts/probe_determinism.py [zoo]     # on one GPU

At the flagship geometry of `chip_smoke.py` phase 5 (Qwen3Multi, bf16,
B 64 x S 505, dropout 0.2, through the kernels):

1. Two forward and backward passes of one model on one batch with the same
   dropout seeds. Every parameter whose grad differs between them, with the
   largest difference. Then the same two passes with a hook on every node of
   the autograd graph, fingerprinting each node's incoming and outgoing
   grads (the sum of their bit patterns): the first node, in the order the
   backward runs them, whose incoming grads are equal in both passes and
   whose outgoing grads differ is the op that does not reproduce.
2. The same pass under `torch.use_deterministic_algorithms(True)`: every op
   it would refuse (its `warn_only` warnings), then what the strict mode
   raises, without and with CUBLAS_WORKSPACE_CONFIG.
3. The device time of a phase 5 `Trainer` step (the kernels' sum under
   `torch.profiler`, three steps) in three settings, in turns: table
   lookups by `F.embedding` with PyTorch's default algorithms; the same
   with deterministic algorithms on; the port's `modules/layers.lookup`
   (a one-hot product in the backward). And whether two passes agree bit
   for bit in each.

Sections 1 and 2 run the lookups by `F.embedding` (the port before
`lookup`), then section 1 again with the port's. With `zoo`:

4. each discriminative backbone's training step at `chip_smoke.py` phase
   13's geometry: its device time with each lookup, in turns, and whether
   its embedding tables' grads reproduce under each.

Prints the card's name and power limit first. Needs CUDA.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fingerprint(ts):
    """One int64 a tensor: the sum of its bit pattern (a last-bit change
    moves it), -1 for a missing grad."""
    import torch

    out = []
    for t in ts:
        if t is None:
            out.append(torch.tensor(-1, dtype=torch.int64, device="cuda"))
            continue
        t = t.detach().contiguous()
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.float16: torch.int16, torch.float64: torch.int64}.get(t.dtype)
        bits = t.view(view) if view is not None else t
        out.append(bits.to(torch.int64).sum())
    return out


def traced_backward(loss):
    """Backward of `loss` with a hook on every graph node: a list, in the
    order the nodes ran, of (node name, incoming grads' fingerprints,
    outgoing grads' fingerprints)."""
    import torch

    seen, stack, records = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))

        def hook(grad_inputs, grad_outputs, node=node):
            records.append((node.name(), _fingerprint(grad_outputs), _fingerprint(grad_inputs)))

        node.register_hook(hook)
        stack.extend(fn for fn, _ in node.next_functions)
    loss.backward()
    torch.cuda.synchronize()
    return [(name, [int(x) for x in gin], [int(x) for x in gout])
            for name, gin, gout in records]


def step_grads(model, loss_fn, batch, seed: int = 1, trace: bool = False):
    import torch

    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch, torch.Generator().manual_seed(seed))
    records = None
    if trace:
        records = traced_backward(loss)
    else:
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads, records


def diff_grads(a: dict, b: dict) -> list:
    """(relative, absolute max difference, name) of each grad that differs,
    largest first."""
    import torch

    out = []
    for n, g in a.items():
        if not torch.equal(g, b[n]):
            d = (g.float() - b[n].float()).abs().max().item()
            out.append((d / max(g.float().abs().max().item(), 1e-30), d, n))
    return sorted(out, reverse=True)


def device_ms(fn, iters: int = 3) -> float:
    """The step's kernel time (sum of device kernel durations) per iteration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: (getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0]
    return sum(dev(e) for e in kernels) / 1e3 / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    import chip_smoke as cs
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.modules import layers
    from gamer_tpu_torch.ops import _build
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import TrainLoopConfig, Trainer
    from gamer_tpu_torch.train.state import OptimizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _build.build()
    cfg = cs.flagship_config(dropout_rate=cs.DROP_RATE)
    batch = cs.make_batch(cfg, 64, 101)
    model = QwenFamilyModel(cfg, device="cuda", seed=0)
    loss_fn = make_loss_fn(model, cfg, deterministic=False)

    port_lookup = layers.lookup
    plain_lookup = lambda ids, w: F.embedding(ids.long(), w)

    def two_passes(label):
        """Section 1 with the current lookup."""
        l1, g1, r1 = step_grads(model, loss_fn, batch, trace=True)
        l2, g2, r2 = step_grads(model, loss_fn, batch, trace=True)
        differ = diff_grads(g1, g2)
        print(f"1. {label}: losses {l1!r} / {l2!r}; {len(differ)} of {len(g1)} grads "
              f"differ", flush=True)
        for rel, d, n in differ:
            print(f"   {n}: max |d| {d:.3e}, {rel:.3e} of its largest", flush=True)
        assert [r[0] for r in r1] == [r[0] for r in r2], "the two backward passes ran other nodes"
        culprits = [(i, name) for i, ((name, gin1, gout1), (_, gin2, gout2))
                    in enumerate(zip(r1, r2)) if gin1 == gin2 and gout1 != gout2]
        print(f"   graph nodes {len(r1)}; nodes whose equal incoming grads gave unequal "
              f"outgoing grads: {len(culprits)}", flush=True)
        for i, name in culprits[:20]:
            print(f"   node {i} of the backward: {name}", flush=True)

    layers.lookup = plain_lookup
    two_passes("F.embedding lookups, default algorithms")

    # 2. what deterministic algorithms refuse
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step_grads(model, loss_fn, batch)
    torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).splitlines()[0][:240] for w in caught})
    print(f"2. deterministic algorithms, warn_only: {len(msgs)} distinct refusals", flush=True)
    for m in msgs:
        print(f"   {m}", flush=True)
    for config in (None, ":4096:8"):
        if config:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = config
        torch.use_deterministic_algorithms(True)
        try:
            step_grads(model, loss_fn, batch)
            print(f"   strict, CUBLAS_WORKSPACE_CONFIG={config}: no refusal", flush=True)
        except RuntimeError as e:
            print(f"   strict, CUBLAS_WORKSPACE_CONFIG={config}: refused: "
                  f"{str(e).splitlines()[0][:300]}", flush=True)
        finally:
            torch.use_deterministic_algorithms(False)

    # 3. the cost of each setting on phase 5's step, and whether it reproduces
    @contextlib.contextmanager
    def algorithms():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                yield
        finally:
            torch.use_deterministic_algorithms(False)

    @contextlib.contextmanager
    def using(fn, ctx=contextlib.nullcontext):
        layers.lookup = fn
        try:
            with ctx():
                yield
        finally:
            layers.lookup = port_lookup

    settings = {"F.embedding, default algorithms": lambda: using(plain_lookup),
                "F.embedding, deterministic algorithms": lambda: using(plain_lookup, algorithms),
                "port's one-hot lookup": lambda: using(port_lookup)}
    trainer = Trainer(loss_fn, model, OptimizerConfig(learning_rate=5e-4,
                                                      lr_scheduler_type="constant",
                                                      total_steps=100), TrainLoopConfig(seed=0))
    times = {k: [] for k in settings}
    for name in list(settings) + list(settings)[::-1]:
        with settings[name]():
            times[name].append(device_ms(lambda: trainer.train_step(batch)))
    for name, setting in settings.items():
        with setting():
            _, a, _ = step_grads(model, loss_fn, batch)
            _, b, _ = step_grads(model, loss_fn, batch)
        print(f"3. {name}: phase 5 step device time {[round(t, 3) for t in times[name]]} ms "
              f"(three steps each, two turns); two passes bit-identical: "
              f"{not diff_grads(a, b)} (card {card})", flush=True)
    layers.lookup = port_lookup
    two_passes("the port's one-hot lookups, default algorithms")
    if "zoo" in sys.argv[1:]:
        zoo(card, {"F.embedding": plain_lookup, "port's one-hot lookup": port_lookup}, layers)
    return 0


def zoo(card: str, lookups: dict, layers) -> None:
    """4. Each discriminative backbone's training step (`chip_smoke.py`
    phase 13's geometry, `profile_torch_port.py rec`'s random batch): its
    device time with each lookup, in turns, and whether two passes give its
    embedding tables' grads bit for bit."""
    import torch

    import chip_smoke as cs
    from gamer_tpu_torch.models.discriminative import DisModelConfig
    from gamer_tpu_torch.tasks import train_smb_rec as TR
    from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer

    n_items, n_users, his = 6000, 700, 20
    for backbone in cs.PHASE13_BACKBONES:
        cfg = DisModelConfig.from_file(os.path.join(REPO, "config", "dis-models", backbone))
        L = his + 1 if backbone == "MBHT" else his
        if backbone == "MBHT":
            cfg = cfg.replace(scales=[5, 3, 7])
        model = TR.build_dis_model(backbone, cfg, n_items, L, 3, n_users, "cuda")
        opt = make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-3, weight_decay=0.0,
                                             lr_scheduler_type="constant", warmup_ratio=0.0,
                                             max_grad_norm=0.0), model)
        loss_fn = TR.make_dis_loss_fn(backbone, model, cfg)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in cs.random_rec_batch(256, L, his, n_items, n_users, 0).items()}
        tables = [f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Embedding)]
        times, same = {k: [] for k in lookups}, {}
        for name in list(lookups) + list(lookups)[::-1]:
            layers.lookup = lookups[name]
            times[name].append(device_ms(lambda: TR.train_step(model, opt, loss_fn, batch,
                                                               TR.step_generator(0, 0))))
        for name, fn in lookups.items():
            layers.lookup = fn
            passes = []
            for _ in range(2):
                model.zero_grad(set_to_none=True)
                loss_fn(batch, TR.step_generator(0, 1)).backward()
                passes.append({n: model.get_parameter(n).grad.clone() for n in tables})
            same[name] = sum(torch.equal(passes[0][n], passes[1][n]) for n in tables)
        print(f"4. {backbone} fp32 B=256 L={L}: step device time " + "; ".join(
            f"{name} {[round(t, 3) for t in times[name]]} ms, tables bit-identical twice "
            f"{same[name]} of {len(tables)}" for name in lookups) + f" (card {card})", flush=True)
        layers.lookup = lookups["port's one-hot lookup"]
        del model, opt


if __name__ == "__main__":
    sys.exit(main())
