"""Training steps through `train.loop.make_train_step`'s `train_step`.

Set-up draws the stage's weights on the card from the seed, builds one
training state (parameters, optimizer state, error buffer) and one
`train_step`, and drives them through the mix's `checked_steps` first
steps, which warm every shape and are what the check reads: each step's
loss, the first gradient as `update` got it (the microbatches' mean,
before compression) and the parameters' change after the last.  The
window then calls the same `train_step` on the same state, step after
step, reading each step's loss as the program's trainer does, until
`--seconds` have passed.

The check: the plain reference follows the same first steps from the
same weights and batches in float32 (weights stored in bf16 as the
configuration states), with its own compression and int8 AdamW.
`loss_gap` is the relative gap of the first step's loss (the later
steps' losses follow a trajectory that the first, large Adam step makes
sensitive to rounding: they are read, `loss_gap_later`, and not
compared); `grad_gap` and `update_gap` the largest gap between the
program's and the reference's norm of a leaf, over the larger of the
reference's norm of that leaf and of the median leaf, and
`grad_gap_median`, `update_gap_median` the median leaf's gap.  Leaves
whose reference gradient is under 1e-3 of the median leaf's are left
out of all four.
"""
from __future__ import annotations

import math
import time

import torch

from bench import gen, reference, weights
from bench.devtrace import WINDOW, Tracer, wrapped
from bench.drivers import (flat, model_config, nest, peak_bytes, release,
                           reset_peak, sync)
from bench.harness import Ctx, Run, say
from bench.reference import optim8
from bench.reference import prec as PREC

SMALL_GRAD = 1e-3


def stage_layers(ctx: Ctx) -> int:
    model = ctx.config["model"]
    return model["n_layers"] // ctx.mix.get("pipeline_stages", 1)


def trainable(ctx: Ctx):
    """The configuration's reference module, which has to give `loss`
    for a training cell to be checked."""
    arch = reference.module(ctx.config)
    if not hasattr(arch, "loss"):
        raise SystemExit(f"{ctx.cell}: the reference module {arch.__name__} "
                         f"has no loss, so a training cell of "
                         f"{ctx.config['name']} cannot be checked")
    return arch


def change_norms(ctx: Ctx, params: dict, L: int) -> dict:
    """Each leaf's norm of (now - as drawn), the drawn values made again
    leaf by leaf."""
    dev, seed = ctx.device, ctx.seed
    now = flat(params)
    out = {}
    for leaf in weights.leaves(ctx.config):
        if leaf.stacked and not weights.present(leaf, L):
            continue              # in none of the stage's layers
        key = ".".join(leaf.path)
        p = now[key]
        if leaf.stacked:
            sq = sum(float(torch.sum((p[j].float() - weights.draw_leaf(
                leaf, seed, dev, i).float()).square()))
                for j, i in enumerate(weights.present(leaf, L)))
        else:
            sq = float(torch.sum((p.float() - weights.draw_leaf(
                leaf, seed, dev).float()).square()))
        out[key] = math.sqrt(sq)
    return out


class Training:
    """The program's side: one state and one `train_step`."""

    def __init__(self, ctx: Ctx):
        trainable(ctx)
        from repro_torch.optim import adamw, adamw8bit
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.optim.grad_compress import init_error_buffer
        from repro_torch.train.loop import TrainLoopConfig, make_train_step

        model, mix = ctx.config["model"], ctx.mix
        self.L = stage_layers(ctx)
        self.cfg = model_config(model, self.L)
        self.loop = TrainLoopConfig(
            microbatches=mix["microbatches"],
            grad_compress=mix["grad_compress"],
            optimizer=AdamWConfig(lr=mix["lr"], grad_clip=mix["grad_clip"]))
        self.params = weights.draw(ctx.config, ctx.seed, ctx.device, self.L)
        self.opt = (adamw8bit if self.cfg.opt_8bit else adamw).init(
            self.params)
        self.err = (init_error_buffer(self.params) if mix["grad_compress"]
                    else None)
        self.step_fn = make_train_step(self.cfg, self.loop)
        self.batches = gen.train_batches(mix, model["vocab"], ctx.seed,
                                         ctx.device)
        self.steps = 0

    def step(self) -> float:
        b = self.batches[self.steps % len(self.batches)]
        self.params, self.opt, met, self.err = self.step_fn(
            self.params, self.opt, b, self.err)
        self.steps += 1
        return float(met["loss"])

    def checked(self, ctx: Ctx) -> dict:
        """The first steps and what the check reads of them: each step's
        loss, each leaf's norm of the first gradient as `update` gets it
        (averaged over the microbatches, before compression) and of the
        parameters' change after the last."""
        from repro_torch.train import loop as LOOP

        grads: dict = {}

        def first(update):
            def inner(cfg, loop_cfg, params, g, *a, **kw):
                if not grads:
                    grads.update({k: float(torch.linalg.vector_norm(
                        v.float())) for k, v in flat(g).items()})
                return update(cfg, loop_cfg, params, g, *a, **kw)
            return inner

        with wrapped(LOOP, "update", first):
            losses = [self.step() for _ in range(ctx.mix["checked_steps"])]
        return {"losses": losses, "grads": grads,
                "updates": change_norms(ctx, self.params, self.L)}


def reference_steps(ctx: Ctx, batches: list, prec=PREC.F32,
                    half_batch: bool = False) -> dict:
    """The reference's first steps from the drawn weights: losses, first
    gradient and change norms per leaf.  `half_batch` plants a fault:
    each microbatch's loss over the first half of its rows only."""
    model, mix, dev = ctx.config["model"], ctx.mix, ctx.device
    arch = trainable(ctx)
    L = stage_layers(ctx)
    PREC.no_tf32()
    P = flat(weights.draw(ctx.config, ctx.seed, dev, L))
    mu = {k: optim8.zeros_like_moment(p) for k, p in P.items()}
    nu = {k: optim8.zeros_like_moment(p) for k, p in P.items()}
    err = {k: torch.zeros(p.shape, device=dev) for k, p in P.items()}
    n_mb = mix["microbatches"]
    losses, grads = [], {}
    for step, batch in enumerate(batches[:mix["checked_steps"]]):
        gsum = {k: torch.zeros(p.shape, device=dev) for k, p in P.items()}
        nll_t = n_t = 0.0
        B = batch["tokens"].shape[0]
        for i in range(n_mb):
            rows = slice(i * B // n_mb, (i + 1) * B // n_mb)
            tok, lab = batch["tokens"][rows], batch["labels"][rows]
            if half_batch:
                tok, lab = tok[:len(tok) // 2], lab[:len(lab) // 2]
            n_rows = float(lab.numel())
            # the microbatch's mean loss, its gradient a row at a time
            for j in range(len(tok)):
                leaves = {k: p.detach().float().requires_grad_()
                          for k, p in P.items()}
                nll, _ = arch.loss(model, nest(leaves), tok[j:j + 1],
                                   lab[j:j + 1], prec)
                gs = torch.autograd.grad(nll / n_rows,
                                         list(leaves.values()))
                for k, g in zip(leaves, gs):
                    gsum[k] += g
                nll_t += float(nll.detach())
                del leaves, gs, nll
            n_t += n_rows
        losses.append(nll_t / n_t)
        g = {k: v / n_mb for k, v in gsum.items()}
        del gsum
        if step == 0:
            grads = {k: float(torch.linalg.vector_norm(v))
                     for k, v in g.items()}
        if mix["grad_compress"]:
            for k in g:
                g[k], err[k] = optim8.compress(g[k], err[k])
        P, mu, nu = optim8.adamw_step(P, g, mu, nu, step + 1, mix["lr"],
                                      mix["grad_clip"])
        del g
    P0 = flat(weights.draw(ctx.config, ctx.seed, dev, L))
    updates = {k: float(torch.linalg.vector_norm(P[k].float() - P0[k].float()))
               for k in P}
    return {"losses": losses, "grads": grads, "updates": updates}


def gaps(prog: dict, ref: dict) -> dict:
    """The check's numbers of one trajectory against the reference's,
    with what they were read from: the worst leaves, the later steps'
    loss gap (not compared) and the leaves left out."""
    med_g = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    med_u = sorted(ref["updates"].values())[len(ref["updates"]) // 2]
    keep = [k for k, g in ref["grads"].items() if g >= SMALL_GRAD * med_g]

    def by_leaf(a, b, med):
        return sorted((abs(a[k] - b[k]) / max(b[k], med), k) for k in keep)

    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                               ref["losses"])]
    g = by_leaf(prog["grads"], ref["grads"], med_g)
    u = by_leaf(prog["updates"], ref["updates"], med_u)
    return {"loss_gap": rel[0], "grad_gap": g[-1][0],
            "grad_gap_median": g[len(g) // 2][0], "update_gap": u[-1][0],
            "update_gap_median": u[len(u) // 2][0],
            "loss_gap_later": max(rel[1:], default=0.0),
            "grad_leaf": g[-1][1], "update_leaf": u[-1][1],
            "left_out": sorted(set(ref["grads"]) - set(keep))}


def run(ctx: Ctx) -> Run:
    from repro_torch.train import loop as LOOP

    dev = ctx.device
    prog = Training(ctx)
    checked = prog.checked(ctx)
    sync(dev)
    setup_peak = peak_bytes(dev)
    reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t0
    tracer = Tracer(ctx.trace)

    def ranged(update):
        def inner(*a, **kw):
            with tracer.span("bench.optimizer"):
                return update(*a, **kw)
        return inner

    losses = []
    first = prog.steps
    with wrapped(LOOP, "update", ranged), tracer:
        with tracer.span(WINDOW):
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < ctx.seconds:
                with tracer.span("bench.step"):
                    losses.append(prog.step())
            sync(dev)
            window_s = time.perf_counter() - t_start
    window_peak = peak_bytes(dev)
    mix = ctx.mix
    steps = prog.steps - first
    say(f"setup {setup_s:.2f} s, window {window_s:.2f} s: {steps} steps, "
        f"checked losses {checked['losses']}")
    batches = prog.batches[:mix["checked_steps"]]
    del prog
    release(dev)
    t0 = time.perf_counter()
    nums = gaps(checked, reference_steps(ctx, batches))
    say(f"check {time.perf_counter() - t0:.2f} s: {nums}")
    limits = ctx.cell_spec["check"]["limits"]
    work = {"steps": steps, "tokens": steps * mix["batch"] * mix["seq_len"],
            "losses": losses, "layers": stage_layers(ctx), "window_s": window_s}
    return Run(ctx.config, ctx.mix, setup_s=setup_s, window_s=window_s,
               peak_bytes=window_peak,
               memory_peak_bytes=max(setup_peak, window_peak),
               attempted=steps,
               failed=sum(1 for x in losses if not math.isfinite(x)),
               work=work, trace=tracer.trace,
               checks={k: (nums[k], limits[k]) for k in limits})
