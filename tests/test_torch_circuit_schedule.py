"""The level schedule of the CUDA level walk, and its routing, on the CPU.

`cuda_circuit_sim.schedule` groups each plan row's gates by logic level
(`circuit_sim.level_schedule`) for `circuit_sim.cu`'s shared-plane walk,
and `cuda_circuit_sim.plan` picks the design and the word columns a block
owns.  The schedule is built in tensor ops on the plan's device and the
routing is pure Python, so both are held here on the CPU: levels equal
the compiler's `ir.levels` on the golden programs, every evaluated gate
reads only earlier levels, a wrong `levels` array is refused, the fleet
padding's schedule stays inside each row and is built once per set of
plans, and the routing crosses the shared-memory limit where it should.

`level_walk` below is a plain PyTorch walk that runs a plan the way the
kernel does — level by level, only the scheduled gates, over a plane whose
unwritten nodes hold junk — and must equal the reference (`repro`'s SWAR
scan and its Pallas kernel in interpret mode) and the port's plain
version bit for bit.  Inputs come from seeded numpy streams.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import circuit_sim as RCS  # noqa: E402
from repro.kernels import pallas_circuit_sim as PS  # noqa: E402
from repro_torch.compile.artifact import (  # noqa: E402
    load_manifest, load_program)
from repro_torch.compile.ir import CircuitIR  # noqa: E402
from repro_torch.compile.program import CircuitProgram  # noqa: E402
from repro_torch.kernels import circuit_sim as CS  # noqa: E402
from repro_torch.kernels import cuda_circuit_sim as CK  # noqa: E402

EMIT = Path(__file__).parent / "golden_emit"
GOLDEN = Path(__file__).parent / "golden"
JUNK = 0x5A5A5A5A


def level_walk(op, in0, in1, outputs, words, n_inputs, order, starts):
    """Output words `(P, n_out, W)` of a schedule-driven walk: each level's
    gates at once, unscheduled nodes left holding junk."""
    P, G = op.shape
    W = words.shape[-1]
    vals = torch.full((P, n_inputs + G, W), JUNK, dtype=torch.int32)
    vals[:, :n_inputs] = words
    masks = CS.ANF_MASKS[:, op.long()]                       # (4, P, G)
    for p in range(P):
        for lo, hi in zip(starts[p, :-1].tolist(), starts[p, 1:].tolist()):
            gs = order[p, lo:hi].long()
            a = vals[p, in0[p, gs].long()]                   # (n, W)
            b = vals[p, in1[p, gs].long()]
            m0, ma, mb, mab = (m[p, gs, None] for m in masks)
            vals[p, n_inputs + gs] = m0 ^ (ma & a) ^ (mb & b) ^ (mab & a & b)
    return vals[torch.arange(P)[:, None], outputs.long()]


def slot_walk(sched, outputs, words, n_inputs):
    """Output words `(P, n_out, W)` computed as the CUDA level walk does,
    from the schedule's kernel form: plane row `n_inputs + k` for the gate
    in slot k, operand rows from `ent`, ANF bits from `bits`, the taps'
    rows through `rank`; rows no slot writes hold junk."""
    P, G = sched.order.shape
    W = words.shape[-1]
    plane = torch.full((P, n_inputs + G, W), JUNK, dtype=torch.int32)
    plane[:, :n_inputs] = words
    ent = sched.ent.long() & 0xFFFFFFFF
    for p in range(P):
        for lo, hi in zip(sched.starts[p, :-1].tolist(),
                          sched.starts[p, 1:].tolist()):
            ks = torch.arange(lo, hi)
            a = plane[p, ent[p, ks] & 0xFFFF]
            b = plane[p, ent[p, ks] >> 16]
            f = sched.bits[p, ks].long()
            m0, ma, mb, mab = (-((f >> i) & 1).int()[:, None]
                               for i in range(4))
            plane[p, n_inputs + ks] = m0 ^ (ma & a) ^ (mb & b) ^ (mab & a & b)
    out = outputs.long()
    if G:
        slot = sched.rank.long().gather(1, (out - n_inputs).clamp(min=0))
        out = torch.where(out < n_inputs, out, n_inputs + slot)
    return plane[torch.arange(P)[:, None], out]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _golden_programs():
    return {r["name"]: load_program(EMIT / r["program"], device="cpu",
                                    expect_sha256=r["sha256"])
            for r in load_manifest(EMIT)}


def _population(rng, n_in, G, n_out, P):
    """Random feed-forward rows, not level-sorted (uniform operands over
    every earlier node: shallow, very wide levels)."""
    hi = n_in + np.arange(G)
    op = rng.integers(1, 13, size=(P, G))
    in0 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    in1 = rng.integers(0, hi[None, :], size=(P, G)) if G else op
    outputs = rng.integers(0, n_in + G, size=(P, n_out))
    return [np.ascontiguousarray(a, dtype=np.int32)
            for a in (op, in0, in1, outputs)]


def _one_pass_levels(in0, in1, n_in):
    """The definition, gate by gate: inputs at 0, 1 + max of the two."""
    P, G = in0.shape
    lev = np.zeros((P, n_in + G), np.int64)
    for p in range(P):
        for g in range(G):
            lev[p, n_in + g] = 1 + max(lev[p, in0[p, g]], lev[p, in1[p, g]])
    return lev[:, n_in:]


def _assert_valid(order, starts, in0, in1, outputs, n_in):
    """Every scheduled gate reads inputs or gates of earlier levels of its
    own row; the order is a permutation; outputs read scheduled nodes."""
    P, G = in0.shape
    for p in range(P):
        assert sorted(order[p].tolist()) == list(range(G))
        assert starts[p, 0] == 0 and (np.diff(starts[p]) >= 0).all()
        level = np.zeros(n_in + G, np.int64)
        for lv, (lo, hi) in enumerate(zip(starts[p, :-1], starts[p, 1:]),
                                      start=1):
            level[n_in + order[p, lo:hi]] = lv
        for g in order[p, :starts[p, -1]]:
            for x in (in0[p, g], in1[p, g]):
                assert x < n_in or 1 <= level[x] < level[n_in + g]
        for x in outputs[p]:
            assert x < n_in or level[x] >= 1


# -- levels ---------------------------------------------------------------
@pytest.mark.parametrize("name", ["arrhythmia", "breast_cancer", "cardio",
                                  "redwine", "whitewine"])
def test_computed_levels_equal_ir_levels(name):
    ir = _golden_programs()[name].ir
    got = CS.gate_levels(ir.in0[None], ir.in1[None], ir.n_inputs)[0]
    np.testing.assert_array_equal(got, ir.levels)
    plan = [a[None] for a in (ir.op, ir.in0, ir.in1)]
    s = CK.schedule(*plan, ir.n_inputs, levels=ir.levels[None],
                    outputs=ir.outputs[None], device="cpu")
    # the compiler's gates are level-sorted: the order is the identity
    np.testing.assert_array_equal(s.order[0].numpy(), np.arange(ir.n_gates))
    assert s.depth == ir.depth
    assert s.width == np.bincount(ir.levels).max()
    assert s.starts[0, -1] == ir.n_gates
    # computed levels give the same schedule as the carried ones
    computed = CK.schedule(*plan, ir.n_inputs, device="cpu")
    assert (computed.depth, computed.width) == (s.depth, s.width)
    assert torch.equal(computed.rank, s.rank)
    assert torch.equal(computed.program, s.program)


@pytest.mark.parametrize("seed", range(4))
def test_random_plans_schedule_is_valid(seed):
    rng = np.random.default_rng(300 + seed)
    n_in, G, n_out, P = (int(rng.integers(1, 20)), int(rng.integers(0, 400)),
                         int(rng.integers(1, 9)), int(rng.integers(1, 8)))
    op, in0, in1, outputs = _population(rng, n_in, G, n_out, P)
    levels = CS.gate_levels(in0, in1, n_in)
    np.testing.assert_array_equal(levels, _one_pass_levels(in0, in1, n_in))
    np.testing.assert_array_equal(
        CK.gate_levels(_t(in0), _t(in1), n_in).numpy(), levels)
    s = CK.schedule(op, in0, in1, n_in, device="cpu")
    order, starts, depth = s.order.numpy(), s.starts.numpy(), s.depth
    assert starts.shape == (P, depth + 1) and (starts[:, -1] == G).all()
    assert depth == (levels.max() if G else 0)
    _assert_valid(order, starts, in0, in1, outputs, n_in)
    # the order groups by level and keeps plan order inside a level
    for p in range(P):
        lv = levels[p, order[p]]
        assert (np.diff(lv) >= 0).all()
        for v in np.unique(lv):
            assert (np.diff(order[p][lv == v]) > 0).all()


def test_levels_of_a_not_feed_forward_plan_raise():
    in0 = np.array([[0, 3]])
    with pytest.raises(ValueError, match="feed-forward"):
        CS.gate_levels(in0, np.zeros_like(in0), 2)
    with pytest.raises(ValueError, match="range"):
        CS.gate_levels(np.array([[0, 9]]), np.zeros_like(in0), 2)


@pytest.mark.parametrize("corrupt", ["same_level", "below_input", "negative",
                                     "unscheduled_input", "unscheduled_tap",
                                     "shape"])
def test_corrupted_levels_are_rejected(corrupt):
    ir = _golden_programs()["cardio"].ir
    lev = ir.levels.astype(np.int64).copy()
    reads_gate = ir.in0 >= ir.n_inputs
    # a gate g whose first operand is a gate of level >= 2
    g = int(np.flatnonzero(reads_gate & (
        lev[np.where(reads_gate, ir.in0 - ir.n_inputs, 0)] >= 2))[0])
    src = int(ir.in0[g]) - ir.n_inputs
    outputs = ir.outputs
    if corrupt == "same_level":
        lev[g] = lev[src]
    elif corrupt == "below_input":
        lev[g] = lev[src] - 1
    elif corrupt == "negative":
        lev[0] = -1
    elif corrupt == "unscheduled_input":
        lev[src] = 0
    elif corrupt == "unscheduled_tap":
        # the last gate is read by no gate; tap it and leave it out
        outputs = outputs.copy()
        outputs[0] = ir.n_inputs + ir.n_gates - 1
        lev[-1] = 0
    else:
        lev = lev[:-1]
    match = {"unscheduled_tap": "output", "shape": "levels must",
             "negative": "negative"}.get(corrupt, "not a schedule")
    with pytest.raises(ValueError, match=match):
        CK.schedule(ir.op[None], ir.in0[None], ir.in1[None], ir.n_inputs,
                    levels=lev[None], outputs=outputs[None], device="cpu")
    if corrupt not in ("shape", "unscheduled_tap"):
        bad = CircuitIR(n_inputs=ir.n_inputs, op=ir.op, in0=ir.in0,
                        in1=ir.in1, outputs=ir.outputs,
                        levels=lev.astype(np.int32))
        with pytest.raises(ValueError, match=match):
            CircuitProgram(ir=bad, device="cpu")


def test_given_levels_need_the_outputs():
    ir = _golden_programs()["redwine"].ir
    with pytest.raises(ValueError, match="outputs"):
        CK.schedule(ir.op[None], ir.in0[None], ir.in1[None], ir.n_inputs,
                    levels=ir.levels[None], device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_level_grouping_is_a_stable_counting_sort(seed):
    """`level_schedule` on any level array, 0 (not evaluated) included."""
    rng = np.random.default_rng(900 + seed)
    P, G = int(rng.integers(1, 6)), int(rng.integers(1, 200))
    lev = rng.integers(0, int(rng.integers(1, 30)), size=(P, G))
    order, starts, depth, width = CS.level_schedule(torch.from_numpy(lev))
    key = np.where(lev >= 1, lev, lev.max() + 1)
    np.testing.assert_array_equal(
        order.numpy(), np.argsort(key, axis=1, kind="stable"))
    assert depth == lev.max()
    counts = np.stack([np.bincount(r, minlength=depth + 2) for r in key])
    assert width == counts[:, 1:depth + 1].max()
    np.testing.assert_array_equal(
        starts.numpy(), np.concatenate(
            [np.zeros((P, 1), np.int64),
             np.cumsum(counts[:, 1:depth + 1], axis=1)], axis=1))


def test_program_holds_its_schedule():
    prog = _golden_programs()["arrhythmia"]
    s = prog.schedule
    assert s.order.shape == (1, prog.ir.n_gates)
    assert s.depth == prog.ir.depth == 293 and s.width == 18
    assert s.starts.shape == (1, s.depth + 1)
    assert s.order.device == s.starts.device == torch.device("cpu")
    np.testing.assert_array_equal(s.order[0].numpy(),
                                  np.arange(prog.ir.n_gates))
    # the kernel form: slots padded to 4 (entries) and 16 (opcode bits);
    # level-sorted gates keep their node ids as plane rows
    G, n_in = prog.ir.n_gates, prog.ir.n_inputs
    assert s.ent.shape == (1, 3020) and s.bits.shape == (1, 3024)
    np.testing.assert_array_equal(s.rank[0].numpy(), np.arange(G))
    ent = s.ent[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(ent & 0xFFFF, prog.ir.in0)
    np.testing.assert_array_equal(ent >> 16, prog.ir.in1)
    np.testing.assert_array_equal(s.bits[0, :G].numpy(),
                                  CK.ANF_BITS[prog.ir.op])
    assert (s.bits[0, G:] == 0).all() and n_in == 274


# -- fleet padding -----------------------------------------------------------
def _fleet(programs, rng):
    plans, words = [], []
    for i, prog in enumerate(programs.values()):
        plans.append(prog.plan())
        S = 32 * (i + 1) + i
        bits = (rng.random((S, prog.ir.n_inputs)) < 0.5).astype(np.uint8)
        words.append(CS.pack_bits32(torch.from_numpy(bits)))
    return plans, words


def test_pad_fleet_schedule_stays_inside_each_row():
    programs = _golden_programs()
    plans, words = _fleet(programs, np.random.default_rng(4))
    fleet = CK.pad_plans(plans, "cpu")
    wt, W_list = fleet.pad_words(words)
    op, in0, in1, outputs = fleet[:4]
    n_in_max, sched = fleet.n_in_max, fleet.schedule
    T, G_pad = op.shape
    order, starts = sched.order.numpy(), sched.starts.numpy()
    assert order.shape == (T, G_pad)
    assert W_list == [w.shape[1] for w in words]
    assert sched.depth == max(p.ir.depth for p in programs.values())
    _assert_valid(order, starts, in0.numpy(), in1.numpy(), outputs.numpy(),
                  n_in_max)
    for t, prog in enumerate(programs.values()):
        G = prog.ir.n_gates
        depth = max(prog.ir.depth, 1)
        # the row's gates and the zero node, nothing of the padding
        assert starts[t, -1] == G + 1
        assert set(order[t, :G + 1].tolist()) == set(range(G)) | {G_pad - 1}
        # a shallower row's levels past its depth are empty
        assert (starts[t, depth:] == G + 1).all()
    got = level_walk(op, in0, in1, outputs, wt, n_in_max, sched.order,
                     sched.starts)
    want = CS.simulate_population(op, in0, in1, outputs, wt, n_in_max)
    assert torch.equal(got, want)
    assert torch.equal(slot_walk(sched, outputs, wt, n_in_max), want)
    fused = CK.fleet_eval_words(plans, words)
    for t, (prog, w) in enumerate(zip(programs.values(), words)):
        alone = prog.eval_words(w)
        np.testing.assert_array_equal(fused[t].numpy(), alone)


def test_fleet_plan_is_reused_across_dispatches(monkeypatch):
    """The first dispatch of a set of plans pads and schedules them; later
    dispatches of the same plans, whatever their batch widths, reuse that."""
    from repro_torch.kernels import dispatch as D

    programs = _golden_programs()
    plans, _ = _fleet(programs, np.random.default_rng(6))
    builds = []
    pad = CK.pad_plans
    monkeypatch.setattr(CK, "pad_plans",
                        lambda *a: builds.append(a) or pad(*a))
    CK._FLEETS.clear()
    for seed in (7, 8):
        _, words = _fleet(programs, np.random.default_rng(seed))
        got = CK.fleet_eval_words(plans, words)
        # the same contents in new arrays, as each `plan()` call makes
        via_dispatch = D.fleet_eval_words([p.plan() for p in programs.values()],
                                          words, device="cpu")
        for prog, w, g, d in zip(programs.values(), words, got,
                                 via_dispatch):
            np.testing.assert_array_equal(g.numpy(), prog.eval_words(w))
            np.testing.assert_array_equal(d, prog.eval_words(w))
    assert len(builds) == 1
    assert CK.fleet_plan(plans, "cpu") is CK.fleet_plan(plans, "cpu")
    with pytest.raises(ValueError, match="word planes"):
        CK.fleet_eval_words(plans, words[:-1])
    with pytest.raises(ValueError, match="n_inputs"):
        CK.fleet_eval_words(plans, words[::-1])


def test_fleet_plan_cache_is_keyed_by_contents():
    """A changed plan is padded anew; the cache keeps the last few sets."""
    programs = _golden_programs()
    plans, words = _fleet(programs, np.random.default_rng(9))
    CK._FLEETS.clear()
    first = CK.fleet_plan(plans, "cpu")
    op, in0, in1, outputs, n_in = plans[0]
    flipped = op.copy()
    flipped[-1] = 7 if flipped[-1] != 7 else 10    # another two-input gate
    changed = [(flipped, in0, in1, outputs, n_in)] + plans[1:]
    second = CK.fleet_plan(changed, "cpu")
    assert second is not first and not torch.equal(second.op, first.op)
    assert CK.fleet_plan(plans, "cpu") is first
    for t in range(CK.FLEET_CACHE):
        CK.fleet_plan(plans[t % 5:t % 5 + 1] * (t + 1), "cpu")
    assert len(CK._FLEETS) == CK.FLEET_CACHE
    assert CK.fleet_plan(plans, "cpu") is not first


def test_pad_plans_refuses_a_bad_tenant_plan():
    programs = _golden_programs()
    plans, words = _fleet(programs, np.random.default_rng(5))
    op, in0, in1, outputs, n_in = plans[1]
    bad = in0.copy()
    bad[0] = n_in + 5                   # gate 0 reads a later gate
    with pytest.raises(ValueError, match="feed-forward"):
        CK.pad_plans([plans[0], (op, bad, in1, outputs, n_in)], "cpu")
    with pytest.raises(ValueError, match="output"):
        CK.fleet_eval_words([(op, in0, in1, outputs + 10 ** 6, n_in)],
                            words[1:2])


def test_schedule_buffer_layout():
    """`program` holds the level offsets, the slot entries and the opcode
    bits of each row, padded for 16-byte copies, as `row_words` counts."""
    rng = np.random.default_rng(12)
    plan = _population(rng, 5, 37, 3, 3)
    s = CK.schedule(*plan[:3], 5, outputs=plan[3], device="cpu")
    assert s.program.shape == (3, CK.row_words(37, s.depth))
    assert CK.row_words(37, s.depth) % 4 == 0
    np.testing.assert_array_equal(s.program[:, : s.depth + 1].numpy(),
                                  s.starts.numpy())
    assert s.ent.shape == (3, 40) and s.bits.shape == (3, 48)
    order = s.order.numpy()
    rows = np.arange(3)[:, None]
    np.testing.assert_array_equal(s.bits[:, :37].numpy(),
                                  CK.ANF_BITS[plan[0][rows, order]])
    np.testing.assert_array_equal(s.rank.numpy()[rows, order],
                                  np.broadcast_to(np.arange(37), (3, 37)))
    assert (s.ent[:, 37:] == 0).all() and (s.bits[:, 37:] == 0).all()


# -- routing ---------------------------------------------------------------
ARRHYTHMIA = (274 + 3020, 3020, 293, 18, 4)   # n_nodes, G, depth, width, n_out


def _limit_nodes(G, depth, n_out):
    """The most nodes whose one-column plane and schedule fit."""
    n = 1
    while CK.level_smem_bytes(2 * n, G, depth, n_out, 1) <= CK.SMEM_MAX:
        n *= 2
    lo, hi = n, 2 * n            # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = CK.level_smem_bytes(mid, G, depth, n_out, 1) <= CK.SMEM_MAX
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


def _cost(n_nodes, G, W, P, depth, width, n_out, C):
    """(waves, walking warps an SM) of C columns a block, or None where the
    plane does not fit; recomputed from the H100's limits."""
    smem = CK.level_smem_bytes(n_nodes, G, depth, n_out, C)
    if smem > CK.SMEM_MAX:
        return None
    walk = min(CK.LEVEL_MAX_THREADS, -(-C * width // 32) * 32)
    threads = max(walk, CK.LEVEL_MIN_THREADS)
    resident = min(CK.SMEM_SM // (smem + CK.SMEM_RESERVED),
                   CK.THREADS_SM // threads, CK.BLOCKS_SM)
    blocks = -(-W // C) * P
    return (-(-blocks // (CK.SMS * resident)),
            min(resident, -(-blocks // CK.SMS)) * walk // 32)


@pytest.mark.parametrize("P", [1, 5, 64])
@pytest.mark.parametrize("W", [0, 1, 32, 2048])
def test_plan_columns_and_threads(W, P):
    n_nodes, G, depth, width, n_out = ARRHYTHMIA
    p = CK.plan(n_nodes, G, W, P, depth, width, n_out)
    assert p.variant == "shared_plane"
    C = p.columns
    assert 1 <= C <= min(CK.MAX_COLUMNS, max(W, 1))
    assert p.smem_bytes == CK.level_smem_bytes(n_nodes, G, depth, n_out, C)
    assert p.smem_bytes <= CK.SMEM_MAX
    assert p.grid == (-(-W // C), P)
    cost = _cost(n_nodes, G, W, P, depth, width, n_out, C)
    assert (p.waves, p.walking_warps) == cost
    # no column count that fits is cheaper, none smaller as cheap
    for other in range(1, min(CK.MAX_COLUMNS, max(W, 1)) + 1):
        c = _cost(n_nodes, G, W, P, depth, width, n_out, other)
        if c is not None:
            assert c > cost or (c == cost and other >= C)
    assert p.level_threads % 32 == 0 and p.level_threads >= C
    assert p.level_threads <= p.threads <= CK.LEVEL_MAX_THREADS
    assert p.threads >= CK.LEVEL_MIN_THREADS


def test_plan_arrhythmia_shapes():
    n_nodes, G, depth, width, n_out = ARRHYTHMIA
    small = CK.plan(n_nodes, G, 32, 1, depth, width, n_out)
    assert (small.columns, small.grid, small.level_threads,
            small.threads) == (1, (32, 1), 32, 128)
    # 16 columns a block: 128 blocks, one wave of one block an SM
    big = CK.plan(n_nodes, G, 2048, 1, depth, width, n_out)
    assert (big.columns, big.grid, big.waves) == (16, (128, 1), 1)
    assert big.level_threads == big.threads == 288
    # five padded tenants at 1,024 readings each: one column a block
    assert CK.plan(274 + 3021, 3021, 32, 5, depth, 52, 4).grid == (32, 5)
    # cardio at 65,536 readings: two columns, 1,024 blocks, 8 an SM of one
    # walking warp each (one column would put 16 warps on an SM)
    cardio = CK.plan(21 + 201, 201, 2048, 1, 36, 16, 2)
    assert (cardio.columns, cardio.waves, cardio.walking_warps) == (2, 1, 8)


@pytest.mark.parametrize("P", [1, 5, 64])
@pytest.mark.parametrize("W", [0, 1, 32, 2048])
def test_plan_crosses_the_shared_memory_limit(W, P):
    G, depth, n_out = 9000, 43, 8
    edge = _limit_nodes(G, depth, n_out)
    at = CK.plan(edge, G, W, P, depth, 300, n_out)
    assert at.variant == "shared_plane" and at.columns == 1
    assert at.smem_bytes <= CK.SMEM_MAX
    past = CK.plan(edge + 1, G, W, P, depth, 300, n_out)
    assert past.variant == "global_scratch"
    assert past.columns == past.threads == CK.GLOBAL_THREADS
    assert past.grid == (-(-W // CK.GLOBAL_THREADS), P)
    assert past.smem_bytes == 0
    # a deeper schedule, or more taps, needs more room
    for deeper in (CK.plan(edge, G, W, P, depth + 1, 300, n_out),
                   CK.plan(edge, G, W, P, depth, 300, n_out + 4)):
        assert deeper.variant == "global_scratch"
    assert CK.plan(edge - 4, G, W, P, depth + 1, 300, n_out).variant == \
        "shared_plane"


def test_route_without_a_schedule_asks_the_fit_of_no_levels():
    assert CK.route(1, 3020, 2048, 274, 4, None).variant == "shared_plane"
    assert CK.route(1, 60000, 2048, 16, 4, None).variant == "global_scratch"


# -- the level walk against the reference ------------------------------------
def _check_walk(plan, words32, n_in, levels=None):
    words = CS.words_tensor(words32, "cpu")
    sched = CK.schedule(*plan[:3], n_in, levels=levels, outputs=plan[3],
                        device="cpu")
    got = level_walk(*[_t(a) for a in plan], words, n_in, sched.order,
                     sched.starts)
    want = CS.simulate_population(*[_t(a) for a in plan], words, n_in)
    assert torch.equal(got, want)
    assert torch.equal(slot_walk(sched, _t(plan[3]), words, n_in), want)
    ref = RCS.simulate_population(plan[0], plan[1], plan[2], plan[3],
                                  words32, n_in)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref, dtype=np.uint32).view(np.int32))
    return got


@pytest.mark.parametrize("per_individual", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_level_walk_equals_reference_on_random_plans(seed, per_individual):
    rng = np.random.default_rng(700 + seed)
    n_in, G, n_out, P = 6, int(rng.integers(1, 120)), 5, 4
    plan = _population(rng, n_in, G, n_out, P)
    shape = (P, n_in, 3) if per_individual else (n_in, 3)
    words32 = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)
    got = _check_walk(plan, words32, n_in)
    pallas = PS.simulate_population(*plan, words32, n_in)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pallas, dtype=np.uint32).view(np.int32))
    dec = CS.decode_words(got)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        PS.population_eval_uint(*plan, words32, n_in)))


@pytest.mark.parametrize("n_in,G,n_out,P,W", [
    (3, 0, 2, 2, 2),          # gateless
    (4, 10, 2, 3, 0),         # W == 0
    (5, 30, 3, 2, 1),         # one word
    (8, 50, 0, 2, 2),         # no outputs
    (8, 60, 32, 2, 2)])       # 32 outputs, some tapping inputs
def test_level_walk_degenerate_shapes(n_in, G, n_out, P, W):
    rng = np.random.default_rng(n_in * 100 + G + n_out)
    plan = _population(rng, n_in, G, n_out, P)
    if n_out:
        plan[3][:, 0] = 1                     # an output tapping an input
    words32 = rng.integers(0, 2 ** 32, size=(n_in, W), dtype=np.uint64) \
        .astype(np.uint32)
    got = _check_walk(plan, words32, n_in)
    assert got.shape == (P, n_out, W)
    np.testing.assert_array_equal(
        CS.decode_words(got).numpy(),
        CK.fused_eval_uint(*[_t(a) for a in plan],
                           CS.words_tensor(words32, "cpu"), n_in).numpy())


@pytest.mark.parametrize("name", ["arrhythmia", "breast_cancer", "cardio",
                                  "redwine", "whitewine"])
def test_level_walk_equals_reference_on_golden_programs(name):
    prog = _golden_programs()[name]
    fix = np.load(GOLDEN / f"{name}.npz")
    ir = prog.ir
    words32 = prog.pack_input_bits(prog.binarize(fix["x"])).numpy() \
        .view(np.uint32)
    plan = [np.asarray(a, np.int32)[None]
            for a in (ir.op, ir.in0, ir.in1, ir.outputs)]
    got = _check_walk(plan, words32, ir.n_inputs, levels=ir.levels[None])
    labels = CS.decode_words(got)[0, : fix["x"].shape[0]].numpy()
    np.testing.assert_array_equal(labels, fix["labels"])
    # the score taps over the same schedule, per-individual planes
    tap = np.asarray(ir.taps["score"], np.int32).reshape(1, -1)
    per_ind = np.stack([words32, words32])
    plan2 = [np.concatenate([a, a]) for a in plan[:3]] + [
        np.concatenate([tap, tap])]
    _check_walk(plan2, per_ind, ir.n_inputs,
                levels=np.stack([ir.levels, ir.levels]))
