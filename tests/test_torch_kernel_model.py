"""`repro_torch.roofline.kernel_model`: the Hopper bounds of every kernel.

* The model reproduces the bounds `chip_smoke.py` printed on the card
  (`PERF.md` §6 kernel table): the gate walk at arrhythmia @1,024, an
  objective launch at pop 24 (384 rows of the campaign's output
  popcounts, 14 gates a row on average), four CGP children at n = 130
  (852 gates a child on average), the ternary matmul at llama3.2-1b's
  shapes, the WKV-6 scan at rwkv6-7b's and the popcount at 65,536 x 9.
* `chip_smoke.py` defines no peak, rate or bound of its own: it takes
  them from the package.
* The designs' byte counts order as their traffic does (the shared plane
  below the global scratch below the plain walk), and the fleet's padding
  efficiency equals the reference's formula.
"""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.roofline import kernel_model as KM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _printed(x: float, want: float) -> bool:
    """`x` rounded to the significant digits `want` was printed with."""
    mant = f"{want:e}".split("e")[0].rstrip("0").replace(".", "")
    return float(f"{x:.{max(len(mant.lstrip('0')), 1)}g}") == want


@pytest.mark.parametrize("programs,decode,shared,depth,want", [
    # arrhythmia @1,024 readings: n_in 274, G 3,020, n_out 4, W 32
    ([(274, 3020, 4, 32)], True, False, 293,
     {"bytes": 2.3e-5, "chain": 0.00444}),
    # arrhythmia @65,536 readings (W 2,048)
    ([(274, 3020, 4, 2048)], True, False, 293,
     {"bytes": 7.6e-4, "chain": 0.00444}),
    # cardio @1,024 readings: n_in 21, G 201, n_out 3 (score bits), W 32
    ([(21, 201, 3, 32)], True, False, 36,
     {"bytes": 2.7e-6, "chain": 0.000545}),
    # four CGP children at n = 130 over the shared 2**17-vector plane
    ([(130, 852, 8, 4096)] * 4, True, True, 251,
     {"bytes": 0.00127, "ops": 0.00125, "chain": 0.00380}),
    # the same children with each child's plane counted
    ([(130, 852, 8, 4096)] * 4, True, False, 251,
     {"bytes": 0.00318, "ops": 0.00125}),
])
def test_gate_walk_bounds_match_perf_table(programs, decode, shared, depth,
                                           want):
    ms, by = KM.bound_ms(programs, decode, shared_plane=shared)
    assert by == "bytes"
    assert _printed(ms, want["bytes"])
    if "ops" in want:
        assert _printed(KM.ops_bound_ms(programs), want["ops"])
    if "chain" in want:
        assert _printed(KM.chain_bound_ms(depth), want["chain"])


def test_objective_launch_at_pop_24_matches_perf_table():
    # 384 rows (pop 24 x 16 output neurons), W 40, depth 6
    shape = KM.CircuitShape(P=384, G=14, n_in=3, W=40, n_out=2,
                            shared_words=False, depth=6)
    rl = KM.shared_plane_roofline(shape)
    assert _printed(rl.bound_ms, 0.000662) and rl.dominant == "bytes"
    assert _printed(rl.compute_ms, 1.9e-5)
    assert _printed(rl.chain_s * 1e3, 9.1e-5)
    programs = [(3, 14, 2, 40)] * 384
    assert KM.bound_ms(programs, True) == (rl.bound_ms, "bytes")
    assert KM.ops_bound_ms(programs) == pytest.approx(rl.compute_ms,
                                                      rel=1e-12)


def test_shared_plane_shape_equals_programs():
    shape = KM.CircuitShape(P=4, G=852, n_in=130, W=4096, n_out=8)
    rl = KM.shared_plane_roofline(shape)
    assert rl.bound_ms == KM.bound_ms([(130, 852, 8, 4096)] * 4, True,
                                      shared_plane=True)[0]


@pytest.mark.parametrize("M,K,N,x_bytes,want_us,by", [
    (1, 2048, 2048, 2, 0.32, "bytes"),
    (1, 2048, 512, 2, 0.08, "bytes"),
    (1, 2048, 8192, 2, 1.27, "bytes"),
    (8, 2048, 8192, 2, 1.35, "bytes"),
    (8, 8192, 2048, 2, 1.31, "bytes"),
    (256, 2048, 512, 2, 0.55, "bytes"),
    (768, 2048, 8192, 2, 26.1, "operations"),
    (768, 2048, 2048, 2, 6.51, "operations"),
])
def test_ternary_bound_matches_perf_table(M, K, N, x_bytes, want_us, by):
    ms, got_by = KM.ternary_bound_ms(M, K, N, x_bytes)
    assert got_by == by and _printed(ms * 1e3, want_us)


@pytest.mark.parametrize("args,kw,want_us", [
    ((512, 96, 64, False), {}, 21.3),                      # f32 prefill
    ((512, 1, 64, True), {}, 5.24),                        # f32 decode
    ((512, 96, 64, False), {"x_bytes": 2, "u_rows": 64}, 15.7),  # bf16 views
    ((512, 1, 64, True), {"x_bytes": 2, "u_rows": 64}, 5.15),
])
def test_wkv_bound_matches_perf_table(args, kw, want_us):
    ms, by = KM.wkv_bound_ms(*args, **kw)
    assert by == "bytes" and _printed(ms * 1e3, want_us)


def test_wkv_bwd_bound_counts_its_bytes_and_operations():
    """The backward's bound: r, k, v (bf16 here), w, dy read and dr, dk,
    dv, dw written a (row, token, i) element, the checkpoints, u and du,
    and the state gradients where asked; the forward recompute plus the
    reverse walk's flops at the f32 CUDA-core rate.  rwkv6-7b's training
    microbatch (B 2 x H 64 rows, T 256, dh 64, bf16, a shared bonus) is
    bound by its operations, ~26 us (`PERF.md` section 6, row 6
    backward)."""
    BH, T, dh = 128, 256, 64
    ms, by = KM.wkv_bwd_bound_ms(BH, T, dh, False, False, 2, 64)
    flops = (KM.WKV_FLOPS + KM.WKV_BWD_FLOPS) * BH * T * dh * dh
    assert by == "operations" and ms == pytest.approx(
        flops / KM.F32_FLOP_PER_S * 1e3)
    assert _printed(ms * 1e3, 26.0)
    n_bytes = (6 + 8) * BH * T * dh + (6 + 4) * BH * T * dh \
        + 2 * 4 * dh * 64 + 4 * BH * dh * dh * (T // 16)
    bytes_ms = n_bytes / KM.HBM_BYTES_PER_S * 1e3
    assert bytes_ms < ms
    # a state gradient and an initial state add one state a row each way
    ms2, _ = KM.wkv_bwd_bound_ms(1, 1, 4096, True, True)
    ms1, by1 = KM.wkv_bwd_bound_ms(1, 1, 4096, False, False)
    assert by1 == "bytes" and ms2 - ms1 == pytest.approx(
        2 * 4 * 4096 * 4096 / KM.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("B,W,want_us", [(65536, 9, 0.78),
                                         (65536, 32, 2.58),
                                         (4194304, 9, 50.1)])
def test_popcount_bound_matches_perf_table(B, W, want_us):
    ms, by = KM.popcount_bound_ms(B, W)
    assert by == "bytes" and _printed(ms * 1e3, want_us)


def test_chain_term_takes_the_clock():
    assert KM.chain_bound_ms(100, 990.0) == 2 * KM.chain_bound_ms(100)
    assert KM.chain_bound_ms(0) == 0.0


@pytest.mark.parametrize("decode", [True, False])
def test_designs_order_by_traffic(decode):
    shape = KM.CircuitShape(P=4, G=852, n_in=130, W=4096, n_out=8,
                            depth=251)
    rows = {r["variant"]: r for r in KM.variant_rows(shape, decode)}
    assert list(rows) == ["plain", "shared_plane", "global_scratch"]
    assert rows["shared_plane"]["hbm_bytes"] \
        < rows["global_scratch"]["hbm_bytes"] < rows["plain"]["hbm_bytes"]
    assert len({r["ops"] for r in rows.values()}) == 1
    for r in rows.values():
        assert set(r) == {"variant", "ops", "hbm_bytes", "arith_intensity",
                          "dominant", "bound_s", "chain_s"}
        assert r["chain_s"] == pytest.approx(KM.chain_bound_ms(251) * 1e-3)
        assert r["bound_s"] == pytest.approx(
            max(r["hbm_bytes"] / KM.HBM_BYTES_PER_S,
                r["ops"] / KM.INT32_OPS_PER_S))


def test_fleet_padding_efficiency_matches_reference_formula():
    from repro.roofline import kernel_model as RK

    spec = ((180, 21, 64), (340, 30, 32), (260, 11, 32), (260, 11, 32))
    rl, eff = KM.fleet_roofline([KM.CircuitShape(1, g, f, 32, o)
                                 for g, f, o in spec])
    ref_rl, ref_eff = RK.fleet_roofline([RK.CircuitShape(1, g, f, 32, o)
                                         for g, f, o in spec])
    assert eff == ref_eff and rl.ops == ref_rl.flops
    # the padded launch: (T, G_max + 1) plans, per-tenant padded planes
    assert rl.bytes_accessed == 4 * (4 * (3 * 341 + 64) + 4 * 30 * 32
                                     + 4 * 32 * 32)
    with pytest.raises(ValueError):
        KM.fleet_roofline([])


def test_rates_follow_the_kernel_type():
    # the ternary matmul on the bf16 tensor cores, the WKV scan on the f32
    # CUDA cores, the popcount on the int32 ones
    assert KM.ternary_bound_ms(4096, 4096, 4096, 2) == (
        2 * 4096 ** 3 / KM.BF16_FLOP_PER_S * 1e3, "operations")
    ms, by = KM.wkv_bound_ms(1, 4096, 1024, False)
    assert by == "operations" and ms == pytest.approx(
        KM.WKV_FLOPS * 4096 * 1024 ** 2 / KM.F32_FLOP_PER_S * 1e3)
    rl = KM.Roofline(1.0, 67e12)
    assert rl.dominant == "operations" and rl.bound_s == 1.0


def test_chip_smoke_defines_no_peak_or_bound_of_its_own():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(PEAK_\w*|OPS_PER_GATE_WORD|"
                         r"CHAIN_CYCLES_PER_LEVEL|WKV_FLOPS)\s*=", text, re.M)
    assert not re.search(r"^def \w*bound_ms\(", text, re.M)
    for rate in ("3.35e12", "67e12", "989e12", "1980"):
        assert rate not in text, rate
    assert "from repro_torch.roofline.kernel_model import" in text
