"""`bench/roofline.py`, the frozen yardstick, gives the bounds the port's
`roofline/kernel_model.py` gave for the ternary matmul, the WKV-6 scan and
its backward on the card's data-sheet peaks."""
import pytest

from bench import roofline as R

KM = pytest.importorskip("repro_torch.roofline.kernel_model")

# the ternary matmul at M = 768, llama3.2-1b's four (K, N), µs
TERNARY_M768 = [((2048, 2048), 6.51), ((2048, 512), 1.63), ((2048, 8192), 26.1),
        ((8192, 2048), 26.1)]


@pytest.mark.parametrize("kn,us", TERNARY_M768)
def test_ternary_bounds_at_m768(kn, us):
    K, N = kn
    assert R.ternary_roofline(768, K, N, 2).bound_s * 1e6 == \
        pytest.approx(us, rel=0.004)


def test_wkv_prefill_bounds():
    # f32 (BH, T, dh) prefill BH 512 x T 96: 21.3 µs; the model's bf16
    # views with one (H, dh) bonus: 15.7 µs
    assert R.wkv_roofline(512, 96, 64, False).bound_s * 1e6 == \
        pytest.approx(21.3, abs=0.06)
    assert R.wkv_roofline(512, 96, 64, False, 2, 64).bound_s * 1e6 == \
        pytest.approx(15.7, abs=0.06)


def test_wkv_backward_bound_of_the_training_microbatch():
    # rwkv6-7b's training microbatch (2, 256, 64, 64) bf16: 0.0260 ms
    assert R.wkv_bwd_roofline(128, 256, 64, False, False, 2,
                              64).bound_s * 1e3 == pytest.approx(0.0260,
                                                                 abs=6e-5)


@pytest.mark.parametrize("M,K,N,xb", [(1, 4096, 4096, 2), (8, 5120, 1024, 2),
                                      (16384, 5120, 13824, 2),
                                      (300, 13824, 5120, 4)])
def test_ternary_equals_kernel_model(M, K, N, xb):
    assert R.ternary_roofline(M, K, N, xb).bound_s == \
        KM.ternary_roofline(M, K, N, xb).bound_s


@pytest.mark.parametrize("BH,T,dh,s0,ds,xb,u", [
    (512, 2048, 64, False, False, 2, 64), (128, 256, 64, False, False, 2, 64),
    (3, 257, 64, True, True, 4, None), (64, 1, 32, True, False, 4, 8)])
def test_wkv_equals_kernel_model(BH, T, dh, s0, ds, xb, u):
    assert R.wkv_roofline(BH, T, dh, s0, xb, u).bound_s == \
        KM.wkv_roofline(BH, T, dh, s0, xb, u).bound_s
    assert R.wkv_bwd_roofline(BH, T, dh, s0, ds, xb, u).bound_s == \
        KM.wkv_bwd_roofline(BH, T, dh, s0, ds, xb, u).bound_s


def test_model_flops_and_attention_term():
    analysis = pytest.importorskip("repro_torch.roofline.analysis")
    assert R.model_flops(10 ** 9, 1024, "train") == \
        analysis.model_flops(10 ** 9, 1024, "train")
    assert R.model_flops(7, 3, "serve") == analysis.model_flops(7, 3, "serve")
    # S = 2: three (query, key) pairs, 4 H dh flops each
    assert R.attention_flops(2, 40, 128) == 3 * 4 * 40 * 128
    assert R.wkv_mix_flops(10, 64, 64) == 10 * 4 * 64 * 64 * 64


@pytest.mark.parametrize("S,window", [(1, None), (300, None), (300, 64),
                                      (64, 64), (2048, 1024), (5, 1)])
def test_attention_pairs_equal_kernel_model(S, window):
    assert R.attention_pairs(S, window) == \
        KM.attention_pairs(S, S, True, window)
