"""Serving in calls: one client, closed loop, through `ServingEngine.run`.

Set-up draws the configuration's weights on the card from the seed,
hands them to the program (which packs them where the configuration is
`ternary_packed`), builds the engine and warms it with one full call per
prompt length of the mix.  The window serves whole cycles of the mix's
calls (`gen.serve_calls`) until `--seconds` have passed; a request's
latency runs from its call's entry into `run()` to the call's return,
when every answer of the call is on the host.

The check: `check.sample[length]` slots of the cycle's layout a prompt
length, drawn from the seed, and for each slot one request the window
finished, its cycle drawn uniformly from the seed over the cycles served
(a reservoir of one), are run once more by the plain reference in
float32.  `logit_gap` is the widest gap by which a served token's
reference logit lies below the reference's best; `logit_err` the largest
difference between the head's logits at a prompt's last position, taken
from the timed path, and the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import gen, reference, weights
from bench.devtrace import WINDOW, Tracer, wrapped
from bench.drivers import model_config, peak_bytes, release, reset_peak, sync
from bench.harness import Ctx, Run, say
from bench.reference import prec as PREC

SLOT = 1_000_000          # uid = cycle * SLOT + slot in the cycle's layout


def sample_slots(ctx: Ctx) -> list[int]:
    """Slots of the cycle's layout the check reads, drawn from the seed:
    `check.sample[length]` of each prompt length."""
    layout = gen.call_layout(ctx.mix)
    per = ctx.mix["requests_per_call"]
    rng = np.random.default_rng([ctx.seed, 1])
    out = []
    for plen, n in sorted((int(k), v) for k, v in
                          ctx.cell_spec["check"]["sample"].items()):
        slots = [ci * per + j for ci, call in enumerate(layout)
                 for j, (p, _) in enumerate(call) if p == plen]
        out += sorted(rng.choice(slots, size=n, replace=False).tolist())
    return out


def groups(mix: dict, call: gen.Call) -> list[tuple[int, int]]:
    """The (rows, prompt length) prefill groups a call asks for: its
    prompts bucketed by exact length, cut into `max_batch` rows."""
    by_len: dict = {}
    for p in call.prompts:
        by_len[len(p)] = by_len.get(len(p), 0) + 1
    mb = mix["max_batch"]
    return [(min(mb, n - s), plen) for plen, n in sorted(by_len.items())
            for s in range(0, n, mb)]


class Serving:
    """The program's side of a run: the engine and what the window
    captures."""

    def __init__(self, ctx: Ctx):
        from repro_torch.models.params import quantize_params
        from repro_torch.serve.lm_engine import ServingEngine

        model, mix = ctx.config["model"], ctx.mix
        self.cfg = model_config(model, model["n_layers"])
        params = quantize_params(self.cfg, weights.draw(
            ctx.config, ctx.seed, ctx.device, model["n_layers"]))
        self.engine = ServingEngine(self.cfg, params, mix["max_batch"],
                                    mix["cache_len"], ctx.device)
        del params
        self.sample = set(sample_slots(ctx))
        self.kept: dict = {}          # slot -> (request, prefill logits)
        self._pick = np.random.default_rng([ctx.seed, 2])
        self._group: list = []
        self._fresh = False
        run_group = self.engine._run_group

        def grouped(group, plen):
            self._group, self._fresh = group, True
            return run_group(group, plen)

        self.engine._run_group = grouped

    def capture(self, logits_from_hidden):
        """The head wrapped: the prefill logits of sampled requests kept
        (a row copy on the device)."""
        def head(cfg, params, x):
            out = logits_from_hidden(cfg, params, x)
            if self._fresh:
                self._fresh = False
                for i, r in enumerate(self._group):
                    slot, cycle = r.uid % SLOT, r.uid // SLOT
                    # the slot's request of cycle c replaces the one kept
                    # with chance 1 / (c + 1)
                    if r.uid >= 0 and slot in self.sample and (
                            self._pick.random() * (cycle + 1) < 1.0):
                        self.kept[slot] = (r, out[i, -1].clone())
            return out
        return head

    def requests(self, call: gen.Call, cycle: int) -> list:
        """The call's requests, uid `cycle * SLOT + slot` (-1 in the
        warm-up, cycle < 0)."""
        from repro_torch.serve.lm_engine import Request
        return [Request(cycle * SLOT + slot if cycle >= 0 else -1, list(p),
                        nt) for p, nt, slot in
                zip(call.prompts, call.new_tokens, call.slots or
                    range(len(call.prompts)))]


def serve_window(ctx: Ctx, prog: Serving, tracer: Tracer,
                 seconds: float) -> dict:
    """Whole cycles until `seconds` have passed: the window's record."""
    from repro_torch.models import transformer as TF

    calls = gen.serve_calls(ctx.mix, ctx.config["model"]["vocab"], ctx.seed)
    reqs, grp = [], []
    st = prog.engine.stats
    prefills0 = st.n_prefills
    with wrapped(TF, "logits_from_hidden", prog.capture), tracer:
        with tracer.span(WINDOW):
            t_start = time.perf_counter()
            cycle = 0
            while True:
                for call in next(calls):
                    rq = prog.requests(call, cycle)
                    with tracer.span("bench.call"):
                        t0 = time.perf_counter()
                        prog.engine.run(rq)
                        lat = time.perf_counter() - t0
                    reqs += [(len(r.prompt), len(r.output),
                              r.max_new_tokens, lat) for r in rq]
                    grp += groups(ctx.mix, call)
                cycle += 1
                if time.perf_counter() - t_start >= seconds:
                    break
            sync(ctx.device)
            window_s = time.perf_counter() - t_start
    return {"requests": reqs, "groups": grp, "window_s": window_s,
            "cycles": cycle, "prefills": st.n_prefills - prefills0,
            "max_batch": ctx.mix["max_batch"]}


def reference_hidden(ctx: Ctx, seqs: list[list[int]], precs,
                     block_tokens: int = 8192) -> dict:
    """Every layer of the reference (the configuration's module) over
    each sequence, in each precision: `{prec.name: [hidden (S, D) f32]}`,
    before the final norm.  Sequences of one length go through together,
    in blocks of at most `block_tokens` tokens."""
    config, dev, seed = ctx.config, ctx.device, ctx.seed
    model, arch = config["model"], reference.module(config)
    PREC.no_tf32()
    blocks: list = []
    by_len: dict = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    for S, idx in by_len.items():
        n = max(1, block_tokens // S)
        blocks += [idx[j:j + n] for j in range(0, len(idx), n)]
    with torch.no_grad():
        table = weights.draw_top(config, seed, dev, "embed.tokens")
        xs = {p.name: [table[torch.tensor([seqs[i] for i in idx],
                                          device=dev)].float()
                       for idx in blocks] for p in precs}
        del table
        consts = {S: arch.consts(model, S, dev) for S in by_len}
        for layer in range(model["n_layers"]):
            lp = weights.draw_layer(config, seed, dev, layer)
            for p in precs:
                for b, x in enumerate(xs[p.name]):
                    xs[p.name][b] = arch.layer(model, lp, x,
                                               consts[x.shape[1]], p, layer)
            del lp
    out = {}
    for p in precs:
        rows: list = [None] * len(seqs)
        for idx, x in zip(blocks, xs[p.name]):
            for b, i in enumerate(idx):
                rows[i] = x[b]
        out[p.name] = rows
    return out


def judge(ctx: Ctx, kept: dict, precs=(PREC.F32,)) -> dict:
    """The check's numbers for each precision: `{name: {"logit_gap",
    "logit_err", "served"}}`, read at the served positions only (a
    prompt's last position and each fed-back token's).  For the
    reference's own precision they are the program's: the widest gap by
    which a served token's reference logit lies below the reference's
    best, and the largest difference between the program's prefill
    logits (taken from the timed path) and the reference's.  For any
    other precision they are the control's, the reference computed in
    that precision in the program's place: the gap of the token it puts
    first, and its logits' difference at the prefill position."""
    config, dev, seed = ctx.config, ctx.device, ctx.seed
    model, arch = config["model"], reference.module(config)
    want = len(sample_slots(ctx))
    if len(kept) < want:
        nan = {"logit_gap": float("inf"), "logit_err": float("inf"),
               "served": 0}
        return {p.name: nan for p in precs}
    slots = sorted(kept)
    reqs = [kept[s][0] for s in slots]
    seqs = [list(r.prompt) + list(r.output[:-1]) for r in reqs]
    hid = reference_hidden(ctx, seqs, (PREC.F32, *precs[1:]))
    scale = weights.draw_top(config, seed, dev, "final_norm.scale")
    head = weights.draw_top(config, seed, dev, "lm_head.w")
    out = {}
    with torch.no_grad():
        for p in precs:
            gap = err = 0.0
            served = 0
            for i, r in enumerate(reqs):
                at = slice(len(r.prompt) - 1, len(seqs[i]))
                lr = arch.logits(model, scale, head, hid["f32"][i][at])
                if p is PREC.F32:
                    toks = torch.tensor(r.output, device=dev)[:len(lr)]
                    first = kept[slots[i]][1].float()
                else:
                    lc = arch.logits(model, scale, head,
                                     hid[p.name][i][at], p)
                    toks, first = lc.argmax(-1), lc[0]
                got = lr[:len(toks)].gather(-1, toks[:, None])[:, 0]
                best = lr.max(-1).values[:len(toks)]
                gap = max(gap, float((best - got).max()))
                err = max(err, float((first - lr[0]).abs().max()))
                served += len(toks)
            out[p.name] = {"logit_gap": gap, "logit_err": err,
                           "served": served}
    return out


def run(ctx: Ctx) -> Run:
    dev = ctx.device
    prog = Serving(ctx)
    for call in gen.warmup_calls(ctx.mix, ctx.config["model"]["vocab"]):
        prog.engine.run(prog.requests(call, -1))
    sync(dev)
    setup_peak = peak_bytes(dev)
    reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t0
    tracer = Tracer(ctx.trace)
    rec = serve_window(ctx, prog, tracer, ctx.seconds)
    window_peak = peak_bytes(dev)
    say(f"setup {setup_s:.2f} s, window {rec['window_s']:.2f} s: "
        f"{rec['cycles']} cycles, {len(rec['requests'])} requests")
    kept = prog.kept
    del prog
    release(dev)
    t0 = time.perf_counter()
    nums = judge(ctx, kept)["f32"]
    say(f"check {time.perf_counter() - t0:.2f} s: {nums}")
    limits = ctx.cell_spec["check"]["limits"]
    reqs = rec["requests"]
    return Run(ctx.config, ctx.mix, setup_s=setup_s,
               window_s=rec["window_s"], peak_bytes=window_peak,
               memory_peak_bytes=max(setup_peak, window_peak),
               attempted=len(reqs),
               failed=sum(1 for _, got, want, _ in reqs if got != want),
               work=rec, trace=tracer.trace,
               checks={k: (nums[k], limits[k]) for k in limits})
