"""A step's cost on one H100 from a trace on the `meta` device.

The port of `repro.roofline.component_costing`.  The reference compiles
each repeated unit of a step loop-free because XLA counts a `while` body
once; it multiplies the unit by its trip count.  The port runs eagerly,
so it needs no compiler: `CostMode`, a `TorchDispatchMode`, watches
every aten op of a step run on meta tensors (shapes and dtypes, no
storage) and counts

  * flops: aten products through `torch.utils.flop_counter`'s formulas,
    classed by the dtype of the product's first input (`analysis.
    flop_class`: bf16/f16, or f32 and the rest);
  * bytes: inputs plus outputs of every op that moves data (an input's
    distinct elements: a broadcast view counts its source once); views,
    `detach` and `empty*` count 0, `*_like` factories their output only.
    The port runs unfused, so this is its own traffic, not the upper
    bound XLA's count was;
  * kernel calls: the hand-written kernels' meta branches report each
    call (`kernels.meta`); each is priced by `kernel_model` (the ternary
    matmul at `ternary_roofline`'s bytes and 2*M*K*N bf16 flops, the
    WKV-6 scan and its backward at `wkv_roofline` / `wkv_bwd_roofline`'s
    bytes and float32 operations);
  * with `track_memory`, the live storage bytes and their peak: a storage
    counts from the op that creates it until its last reference dies.

Components and trips follow the reference:

  * train: `layer_fwd_bwd` (x L * mb; remat recomputes as the card
    does), `enc_layer_fwd_bwd` (x enc_layers * mb, whisper),
    `embed_head_loss` (x mb: the embedding, the final norm and the
    chunked loss, forward and backward), `grad_accum` (x mb, when mb >
    1) and `optimizer` (x 1: the mean of the microbatches, gradient
    compression where asked, the update);
  * prefill: `layer_fwd` (x L, with its share of the cache assembly),
    `enc_layer_fwd` (x enc_layers), `embed_head` (x 1: the embedding,
    the final norm and the last position's logits, as the serving engine
    takes them);
  * decode: `layer_decode` (x L) and `embed_head` (x 1).

Each unit runs the model's own code: `models.transformer.apply_block`
through the stack's `_stack` (with its remat), `apply_block_decode`,
`assemble_cache`, `loss_fn` and `forward` with no layers, `decode_step`
with no layers, `train.loop`'s `accumulate_`, `averaged` and `update`.
So the components times their trips give a whole-step trace's product
flops exactly; gradient accumulation and compression are traced, not
added analytically.  A recurrence is one counted kernel call, so the
reference's affine extrapolation in S (`_rwkv_affine`) is not needed.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import meta as KM
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as TF
from repro_torch.models.params import DTYPES, leaves, tree_map
from repro_torch.optim.grad_compress import init_error_buffer
from repro_torch.roofline import kernel_model as KMOD
from repro_torch.roofline.analysis import Roofline, flop_class
from repro_torch.train import loop as LOOP

META = SP.META
# ops that move no data: fresh storage (written by a later op), aliases
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias",
    "_local_scalar_dense"})
# factories that write their output and read nothing of their input
_WRITE_ONLY = frozenset({
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "zeros", "ones", "full", "arange", "scalar_tensor"})


@dataclass
class Cost:
    """Flops by class (aten products and kernels), bytes, kernel calls."""
    flops: dict = field(default_factory=dict)
    bytes: float = 0.0
    kernels: dict = field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def __mul__(self, k: float) -> "Cost":
        return Cost({c: f * k for c, f in self.flops.items()},
                    self.bytes * k,
                    {n: c * k for n, c in self.kernels.items()})

    def __add__(self, o: "Cost") -> "Cost":
        flops, kernels = dict(self.flops), dict(self.kernels)
        for c, f in o.flops.items():
            flops[c] = flops.get(c, 0.0) + f
        for n, c in o.kernels.items():
            kernels[n] = kernels.get(n, 0) + c
        return Cost(flops, self.bytes + o.bytes, kernels)

    def add_flops(self, cls: str, f: float) -> None:
        self.flops[cls] = self.flops.get(cls, 0.0) + f


def tensors_in(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads of an operand: its distinct elements, so a
    broadcast (`expand`, stride 0) view counts its source once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _kernel_roofline(name: str, s: dict) -> KMOD.Roofline:
    if name == "ternary_matmul":
        return KMOD.ternary_roofline(s["M"], s["K"], s["N"], s["x_bytes"])
    if name == "rwkv6_scan":
        return KMOD.wkv_roofline(s["BH"], s["T"], s["dh"], s["with_s0"],
                                 s["x_bytes"], s["u_rows"])
    if name == "rwkv6_scan_bwd":
        return KMOD.wkv_bwd_roofline(s["BH"], s["T"], s["dh"],
                                     s["with_s0"], s["with_ds"],
                                     s["x_bytes"], s["u_rows"])
    raise KeyError(f"no roofline for kernel {name!r}")


@functools.cache
def _out_keyword(packet) -> str:
    """The keyword a flop formula takes the op's output by (it was `out`
    in older PyTorch releases, `out_val` in newer ones)."""
    params = inspect.signature(flop_registry[packet]).parameters
    return "out_val" if "out_val" in params else "out"


def _flop_count(func, args, kwargs, out) -> float:
    packet = func.overloadpacket
    return float(flop_registry[packet](*args, **kwargs,
                                       **{_out_keyword(packet): out}))


@functools.cache
def _composite(func) -> bool:
    """Whether `func` is a composite op (`matmul`, `einsum`, ...), which
    PyTorch decomposes before dispatch except under inference mode."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


class CostMode(TorchDispatchMode):
    """Counts the `Cost` of the ops run under it (see the module
    docstring).  With `track_memory`, `live` and `peak` are the bytes of
    the storages the traced ops created that are still referenced, now
    and at most; storages of the tensors in `external` (the step's
    arguments, alive throughout) are not counted: `external_bytes` is
    theirs, each storage once."""

    def __init__(self, track_memory: bool = False, external=()):
        super().__init__()
        self.cost = Cost()
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}
        self._external = {t.untyped_storage()._cdata:
                          t.untyped_storage().nbytes()
                          for t in tensors_in(external)}
        self.external_bytes = sum(self._external.values())
        self._open = True
        self._depth = 0          # the mode re-enters itself to decompose
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if not self._depth:
            self._stack.enter_context(KM.recording(self._kernel))
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._stack.close()
                self._open = False

    def _kernel(self, name: str, sizes: dict) -> None:
        rl = _kernel_roofline(name, sizes)
        self.cost.bytes += rl.bytes_accessed
        cls = "bf16" if rl.ops_per_s == KMOD.BF16_FLOP_PER_S else "f32"
        self.cost.add_flops(cls, rl.ops)
        self.cost.kernels[name] = self.cost.kernels.get(name, 0) + 1

    def _free(self, key: int) -> None:
        if self._open:
            self.live -= self._seen.pop(key, 0)

    def _track(self, out) -> None:
        for t in tensors_in(out):
            if t.device.type == "cpu":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in self._external:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference mode a composite op arrives whole: run its
            # decomposition here, so its aten ops are counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            first = tensors_in((args, kwargs))[0]
            self.cost.add_flops(flop_class(first.dtype),
                                _flop_count(func, args, kwargs, out))
        if not (func.is_view or name in _NO_TRAFFIC):
            moved = sum(_nbytes(t) for t in tensors_in(out))
            if name not in _WRITE_ONLY:
                moved += sum(_read_bytes(t)
                             for t in tensors_in((args, kwargs)))
            self.cost.bytes += moved
        if self.track_memory:
            self._track(out)
        return out


def cost_of(fn) -> Cost:
    """The `Cost` of `fn()` on meta tensors."""
    with CostMode() as mode:
        fn()
    return mode.cost


# ---------------------------------------------------------------------------
# The units
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _comp(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _head_params(params: dict) -> dict:
    """The tree without its layer stacks (`loss_fn` / `forward` /
    `decode_step` at depth 0)."""
    out = {k: v for k, v in params.items()
           if k not in ("layers", "enc_layers")}
    out["layers"] = {}
    return out


def _rope(cfg: ModelConfig, B: int, S: int):
    batch = {}
    if cfg.rope == "mrope":
        batch["positions"] = _meta((B, 3, S), torch.int32)
    return TF._rope_for(cfg, batch, S, B, META)


def _layer_unit(cfg: ModelConfig, B: int, S: int, *, enc: bool,
                train: bool, cache_len: int | None = None):
    """One layer of `cfg` (an encoder layer when `enc`) at (B, S) through
    `_stack`: forward and, when `train`, backward to its parameters, its
    input and the encoder output it reads.  A prefill layer also builds
    its share of a `cache_len`-slot cache (S slots when None)."""
    c1 = cfg.replace(n_layers=1, enc_layers=1 if cfg.enc_layers else 0)
    params = SP.abstract_params(c1)
    layers = params["enc_layers" if enc else "layers"]
    comp = _comp(cfg)
    x = _meta((B, cfg.enc_seq if enc else S, cfg.d_model), comp)
    enc_out = None
    if enc:
        body = TF.encoder_body(cfg)
    else:
        cos, sin = (None, None) if TF.is_rwkv(cfg) else _rope(cfg, B, S)
        if cfg.enc_layers:
            enc_out = _meta((B, cfg.enc_seq, cfg.d_model), comp)
        body = TF.layer_body(cfg, cos=cos, sin=sin, enc_out=enc_out)
    if not train:
        def fwd():
            with torch.inference_mode():
                _, _, entries = TF._stack(cfg, layers, 1, x, body, True)
                if not enc:
                    TF.assemble_cache(cfg, entries, S, cache_len or S)
        return fwd
    inputs = [x.requires_grad_()] + [p.requires_grad_()
                                     for _, p in leaves(layers)]
    if enc_out is not None:
        inputs.append(enc_out.requires_grad_())

    def fwd_bwd():
        y, aux, _ = TF._stack(cfg, layers, 1, x, body, False)
        outs = [y] + ([aux] if aux.requires_grad else [])
        torch.autograd.grad(outs, inputs, [torch.empty_like(o) for o in outs],
                            allow_unused=True)
    return fwd_bwd


def _embed_head_loss(cfg: ModelConfig, B: int, S: int):
    """`train.loop.grads_of` at depth 0: embedding, final norm and the
    chunked loss, forward and backward."""
    c0 = cfg.replace(n_layers=0, enc_layers=0)
    params = _head_params(SP.abstract_params(cfg))
    batch = SP.train_batch_specs(cfg, ShapeConfig("", S, B, "train"))
    return lambda: LOOP.grads_of(c0, params, batch)


def _embed_head_prefill(cfg: ModelConfig, B: int, S: int):
    c0 = cfg.replace(n_layers=0, enc_layers=0)
    params = _head_params(SP.abstract_params(cfg))
    batch = SP.train_batch_specs(cfg, ShapeConfig("", S, B, "prefill"),
                                 with_labels=False)

    def fwd():
        with torch.inference_mode():
            x, _, _ = TF.forward(c0, params, batch)
            TF.logits_from_hidden(cfg, params, x[:, -1:, :])
    return fwd


def decode_position(S: int) -> int:
    """The position a decode cell's step runs at: the last of an S-slot
    cache (every slot valid); RWKV-6 reads none."""
    return S - 1


def _decode_units(cfg: ModelConfig, B: int, S: int):
    """(one layer's decode step, the step at depth 0)."""
    c1, c0 = cfg.replace(n_layers=1), cfg.replace(n_layers=0)
    params = SP.abstract_params(c1)
    cache1 = TF.init_cache(c1, B, S, device=META)
    cache0 = TF.init_cache(c0, B, S, device=META)
    pos = decode_position(S)
    positions = _meta((B, 3, 1), torch.int32) if cfg.rope == "mrope" \
        else None
    tok = _meta((B, 1), torch.int32)
    x = _meta((B, 1, cfg.d_model), _comp(cfg))
    ctx = TF.decode_context(cfg, cache1, pos, B, META, positions)

    def layer():
        with torch.inference_mode():
            TF.apply_block_decode(cfg, TF._layer(params["layers"], 0),
                                  TF._layer(cache1, 0), x, pos, *ctx)

    def head():
        with torch.inference_mode():
            TF.decode_step(c0, _head_params(params), cache0, tok, pos,
                           positions)
    return layer, head


def _optimizer_units(cfg: ModelConfig, loop_cfg, mb: int):
    """(one microbatch's gradient accumulation, the step's update)."""
    params, opt = SP.abstract_state(cfg)
    grads = tree_map(torch.empty_like, params)
    err = init_error_buffer(params) if loop_cfg.grad_compress else None
    acc_dt = DTYPES[cfg.accum_dtype]
    gsum = LOOP.accumulator(params, acc_dt)
    ntok = _meta((), torch.float32)

    def accumulate():
        LOOP.accumulate_(gsum, grads, acc_dt)

    def update():
        g = grads
        if mb > 1:
            g = LOOP.averaged(LOOP.accumulator(params, acc_dt), mb, ntok)
        LOOP.update(cfg, loop_cfg, params, g, opt, err)
    return accumulate, update


# ---------------------------------------------------------------------------
# Public: one cell
# ---------------------------------------------------------------------------
def components(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
               grad_compress: bool = False,
               cache_len: int | None = None) -> dict:
    """`{name: (unit Cost, trips)}` of one (arch x shape) cell (a prefill
    into a `cache_len`-slot cache, `shape.seq_len` slots when None)."""
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    comps: dict[str, tuple[Cost, int]] = {}
    if shape.kind == "train":
        mb = microbatches
        Bm = max(B // mb, 1)
        comps["layer_fwd_bwd"] = (cost_of(_layer_unit(
            cfg, Bm, S, enc=False, train=True)), L * mb)
        if cfg.enc_layers:
            comps["enc_layer_fwd_bwd"] = (cost_of(_layer_unit(
                cfg, Bm, S, enc=True, train=True)), cfg.enc_layers * mb)
        comps["embed_head_loss"] = (cost_of(_embed_head_loss(cfg, Bm, S)),
                                    mb)
        loop_cfg = LOOP.TrainLoopConfig(microbatches=mb,
                                        grad_compress=grad_compress)
        accumulate, update = _optimizer_units(cfg, loop_cfg, mb)
        if mb > 1:
            comps["grad_accum"] = (cost_of(accumulate), mb)
        comps["optimizer"] = (cost_of(update), 1)
    elif shape.kind == "prefill":
        comps["layer_fwd"] = (cost_of(_layer_unit(
            cfg, B, S, enc=False, train=False, cache_len=cache_len)), L)
        if cfg.enc_layers:
            comps["enc_layer_fwd"] = (cost_of(_layer_unit(
                cfg, B, S, enc=True, train=False)), cfg.enc_layers)
        comps["embed_head"] = (cost_of(_embed_head_prefill(cfg, B, S)), 1)
    else:
        layer, head = _decode_units(cfg, B, S)
        comps["layer_decode"] = (cost_of(layer), L)
        comps["embed_head"] = (cost_of(head), 1)
    return comps


def cell_tokens(shape: ShapeConfig) -> int:
    """Tokens a step of the cell processes."""
    return shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)


def cost_cell(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
              grad_compress: bool = False,
              cache_len: int | None = None) -> dict:
    """The step's roofline on one H100 for one (arch x shape) cell:
    `{"roofline", "breakdown", "tokens", "kernels", "cost"}`."""
    total = Cost()
    breakdown = {}
    for name, (c, trips) in components(cfg, shape, microbatches,
                                       grad_compress, cache_len).items():
        tc = c * trips
        total = total + tc
        breakdown[name] = {"flops": tc.total_flops,
                           "flops_by_class": tc.flops, "bytes": tc.bytes,
                           "kernels": tc.kernels, "trips": trips}
    roof = Roofline(flops_by_class=total.flops, bytes_accessed=total.bytes)
    return {"roofline": roof.summary(), "breakdown": breakdown,
            "tokens": cell_tokens(shape), "kernels": total.kernels,
            "cost": total}
