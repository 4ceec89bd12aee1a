"""`repro_torch.roofline.component_costing`: a step's cost from meta traces.

* On the reduced config of every arch (train with remat in 2
  microbatches, prefill, decode), the components times their trips give
  the whole step's product flops exactly, class by class (the whole step
  traced once by `launch.dryrun.trace_step`), the same kernel calls, and
  bytes within `BYTES_RTOL` (1 %): the units skip only whisper's encoder
  input sum and final norm, elementwise work of a few (B, enc_seq, D)
  tensors.
* Kernel calls: a `ternary_packed` decode step and prefill call the
  ternary matmul 7 times a layer; a remat train step of rwkv6-7b calls the
  WKV-6 forward 2 * L * mb times (the forward and its recompute) and its
  backward L * mb times, with 8-bit moments and gradient compression
  traced too.
* At llama3.2-1b's published width, one layer's forward product flops
  are within `XLA_GAP` (1 %) below the reference's `_cost_layer_fwd` on a
  one-device mesh: XLA's count adds the elementwise flops (norms, rope,
  softmax, SwiGLU) that `torch.utils.flop_counter` leaves out.
* `CostMode` itself: views and `empty` move no bytes, a product counts
  its formula's flops by class and its operands' and result's bytes, and
  the peak follows storages from creation until their last reference
  dies.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.sharding import ShardCtx  # noqa: E402
from repro.roofline import component_costing as RCC  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.dryrun import trace_step  # noqa: E402
from repro_torch.roofline import component_costing as CC  # noqa: E402

BYTES_RTOL = 1e-2
XLA_GAP = 1e-2
SHAPES = {"train": ShapeConfig("t", 32, 4, "train"),
          "prefill": ShapeConfig("p", 32, 2, "prefill"),
          "decode": ShapeConfig("d", 32, 2, "decode")}


def whole_and_parts(cfg, shape, mb=1, grad_compress=False):
    whole = trace_step(cfg, shape, mb, grad_compress)["cost"]
    parts = CC.cost_cell(cfg, shape, mb, grad_compress)
    return whole, parts


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_components_give_the_whole_step(arch, kind):
    cfg = get_config(arch).reduced().replace(remat=True)
    mb = 2 if kind == "train" else 1
    whole, parts = whole_and_parts(cfg, SHAPES[kind], mb)
    total = parts["cost"]
    assert whole.total_flops > 0
    assert total.flops == whole.flops
    assert total.kernels == whole.kernels
    assert total.bytes == pytest.approx(whole.bytes, rel=BYTES_RTOL)
    trips = {name: b["trips"] for name, b in parts["breakdown"].items()}
    L = cfg.n_layers
    if kind == "train":
        assert trips["layer_fwd_bwd"] == L * mb
        assert trips["embed_head_loss"] == mb == trips["grad_accum"]
        assert trips["optimizer"] == 1
    else:
        assert trips["layer_" + ("fwd" if kind == "prefill" else "decode")] \
            == L and trips["embed_head"] == 1
    if cfg.enc_layers and kind != "decode":
        name = "enc_layer_fwd_bwd" if kind == "train" else "enc_layer_fwd"
        assert trips[name] == cfg.enc_layers * mb
    r = parts["roofline"]
    assert r["flops_per_device"] == total.total_flops
    assert r["collective_s"] == 0.0 and r["dominant"] in ("compute", "memory")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_ternary_packed_calls_the_kernel_seven_times_a_layer(kind):
    cfg = get_config("llama3.2-1b").reduced().replace(quant="ternary_packed",
                                                       n_layers=3)
    whole, parts = whole_and_parts(cfg, SHAPES[kind])
    want = {"ternary_matmul": 7 * cfg.n_layers}
    assert whole.kernels == parts["cost"].kernels == want
    assert whole.flops == parts["cost"].flops


def test_ternary_packed_train_step_is_refused():
    cfg = get_config("llama3.2-1b").reduced().replace(quant="ternary_packed")
    with pytest.raises(ValueError, match="cannot be trained"):
        trace_step(cfg, SHAPES["train"], 2)


def test_rwkv_remat_train_step_calls_the_wkv_kernels():
    cfg = get_config("rwkv6-7b").reduced().replace(
        n_layers=4, remat=True, opt_8bit=True)
    mb = 2
    whole, parts = whole_and_parts(cfg, SHAPES["train"], mb,
                                   grad_compress=True)
    L = cfg.n_layers
    want = {"rwkv6_scan": 2 * L * mb, "rwkv6_scan_bwd": L * mb}
    assert whole.kernels == parts["cost"].kernels == want
    assert whole.flops == parts["cost"].flops
    # without remat the forward runs once
    whole, _ = whole_and_parts(cfg.replace(remat=False), SHAPES["train"], mb)
    assert whole.kernels == {"rwkv6_scan": L * mb, "rwkv6_scan_bwd": L * mb}


def test_layer_forward_flops_match_the_reference_at_published_width():
    B, S = 1, 256
    mesh = make_host_mesh()
    ref = RCC._cost_layer_fwd(ref_get_config("llama3.2-1b"), mesh,
                              ShardCtx(mesh), B, S)
    port = CC.cost_of(CC._layer_unit(get_config("llama3.2-1b"), B, S,
                                     enc=False, train=False))
    gap = 1.0 - port.total_flops / ref.flops
    assert 0.0 <= gap < XLA_GAP
    assert set(port.flops) == {"bf16", "f32"}   # projections, f32 attention


def test_cost_mode_counts_bytes_flops_and_peak():
    m = torch.device("meta")
    a = torch.empty(64, 32, dtype=torch.bfloat16, device=m)
    b = torch.empty(32, 16, dtype=torch.bfloat16, device=m)
    with CC.CostMode(track_memory=True, external=(a, b)) as mode:
        v = a.view(32, 64).t()          # views: nothing moves
        assert mode.cost.bytes == 0 and mode.live == 0
        c = a @ b                       # (64, 16) bf16
        assert mode.cost.flops == {"bf16": 2.0 * 64 * 32 * 16}
        assert mode.cost.bytes == 2 * (64 * 32 + 32 * 16 + 64 * 16)
        assert mode.live == 2 * 64 * 16
        d = c.float()                   # (64, 16) f32: a read and a write
        assert mode.live == 6 * 64 * 16
        del c
        assert mode.live == 4 * 64 * 16
        e = torch.zeros_like(d)         # written, nothing read
        del d, e, v
        assert mode.live == 0
    assert mode.peak == 8 * 64 * 16
    assert mode.cost.bytes == 2 * (64 * 32 + 32 * 16 + 64 * 16) \
        + 6 * 64 * 16 + 4 * 64 * 16
