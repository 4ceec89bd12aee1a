"""Routing of the ternary matmul among its three CUDA designs, on the CPU.

`cuda_ternary_matmul.plan` is pure Python: these tests check which design
each shape gets, that decode fills the card, that the K splits cover the
packed rows exactly, and that it raises where the kernels cannot go.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_ternary_matmul as CT  # noqa: E402
from repro_torch.launch.families import FAMILIES  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

# llama3.2-1b's projections, (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
LLAMA_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", LLAMA_KN)
def test_decode_shapes_split_k_fills_the_card(K, N, dtype):
    p = CT.plan(8, K, N, dtype)
    assert p.variant == "split_k"
    assert p.blocks >= CT.SMS
    assert p.splits > 1 and p.grid == (-(-N // CT.GEMV_BLOCK_N), 1,
                                       p.splits)


@pytest.mark.parametrize("M", [1, 2, 5, 7, 8])
def test_small_m_is_split_k_for_both_dtypes(M):
    assert {CT.plan(M, 2048, 200, dt).variant for dt in DTYPES} == \
        {"split_k"}


@pytest.mark.parametrize("M", [256, 768])
@pytest.mark.parametrize("K,N", LLAMA_KN)
def test_bf16_prefill_is_tensor_core(M, K, N):
    p = CT.plan(M, K, N, torch.bfloat16)
    assert p.variant == "tensor_core"
    assert p.tile[0] in CT.MMA_BLOCK_M and p.tile[1] == CT.MMA_BLOCK_N
    assert p.grid[:2] == (-(-N // p.tile[1]), -(-M // p.tile[0]))
    # a grid too thin to fill the card splits K instead
    assert p.tiles >= CT.MMA_FULL_TILES or p.splits == CT.MMA_SPLITS


@pytest.mark.parametrize("M", [9, 16, 65, 256, 768])
def test_f32_large_m_is_cuda_core(M):
    p = CT.plan(M, 2048, 8192, torch.float32)
    assert p.variant == "cuda_core" and p.splits == 1
    assert p.grid == (64, -(-M // 8), 1)


def test_unaligned_bf16_large_m_is_cuda_core():
    assert CT.plan(64, 2048, 512, torch.bfloat16, x_align=2).variant == \
        "cuda_core"
    assert CT.plan(64, 2048, 512, torch.bfloat16, x_align=8).variant == \
        "tensor_core"
    assert CT.plan(8, 2048, 512, torch.bfloat16, x_align=2).variant == \
        "split_k"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [0, 4, 36, 64, 2048, 4004, 8192, 65536])
@pytest.mark.parametrize("M,N", [(1, 130), (8, 512), (8, 8192), (9, 200),
                                 (256, 512), (768, 2048), (768, 8192)])
def test_k_splits_cover_the_packed_rows_exactly(M, K, N, dtype):
    p = CT.plan(M, K, N, dtype)
    K4 = K // 4
    ranges = [(s * p.rows, min((s + 1) * p.rows, K4))
              for s in range(p.splits)]
    covered = [r for lo, hi in ranges for r in range(lo, hi)]
    assert covered == list(range(K4))           # no gap, no overlap
    assert all(hi > lo for lo, hi in ranges) or K4 == 0
    assert p.grid[2] == p.splits
    if p.variant == "split_k":
        assert p.rows <= CT.GEMV_MAX_ROWS
    if p.variant == "tensor_core":
        assert p.rows % CT.MMA_STEP_ROWS == 0


def test_workspace_and_counters_fit_the_plan():
    p = CT.plan(768, 2048, 512, torch.bfloat16)
    assert p.splits > 1
    assert p.tiles == p.grid[0] * p.grid[1]
    assert p.workspace_floats == p.splits * p.tiles * 64 * 128
    assert CT.plan(768, 2048, 8192, torch.bfloat16).workspace_floats == 0


@pytest.mark.parametrize("M,K,N", [(0, 2048, 512), (8, 2048, 0),
                                   (8, 6, 512), (8, -4, 512),
                                   (600_000, 2048, 512)])
def test_plan_raises_value_error_where_the_kernels_cannot_go(M, K, N):
    with pytest.raises(ValueError):
        CT.plan(M, K, N, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8,
                                   torch.float64])
def test_plan_raises_type_error_on_dtype_as_check_operands_does(dtype):
    from repro_torch.kernels import ternary_matmul as TM

    with pytest.raises(TypeError):
        CT.plan(8, 2048, 512, dtype)
    with pytest.raises(TypeError):
        TM.check_operands(torch.zeros(8, 2048, dtype=dtype),
                          torch.zeros(512, 512, dtype=torch.int8),
                          torch.ones(1, 512))


def test_reset_launches_clears_every_count():
    CT.LAUNCHES["ternary_matmul"] = 3
    CT.VARIANT_LAUNCHES["tensor_core"] = 2
    CT.SHAPE_LAUNCHES[8, 2048, 512, torch.bfloat16] = 4
    CT.reset_launches()
    assert CT.LAUNCHES == {"ternary_matmul": 0}
    assert CT.VARIANT_LAUNCHES == dict.fromkeys(CT.VARIANTS, 0)
    assert not CT.SHAPE_LAUNCHES


@pytest.mark.parametrize("fam", [f for f in FAMILIES
                                 if f.quant == "ternary_packed"],
                         ids=lambda f: f.arch)
def test_served_family_shapes_have_plans(fam):
    """Every shape a served family gives the kernel in bf16 — decode at
    batch 1 (the warm-up) and 8, prefill of one prompt and of 8, whisper's
    encoder over 1 and 8 x 1,500 frames — has a plan: split-K at decode,
    the tensor cores at prefill."""
    cfg = fam.config()
    ms = {1: "split_k", 8: "split_k", fam.prompt_tokens: "tensor_core",
          8 * fam.prompt_tokens: "tensor_core"}
    if cfg.enc_layers:
        ms |= {cfg.enc_seq: "tensor_core", 8 * cfg.enc_seq: "tensor_core"}
    for K, N in P.lin_shapes(cfg):
        for M, variant in ms.items():
            p = CT.plan(M, K, N, torch.bfloat16)
            assert p.variant == variant, (M, K, N)
            assert p.rows * (p.splits - 1) < K // 4 <= p.rows * p.splits
