"""The port's checkpoints held against `repro.checkpoint` on the CPU.

* The port's flatten gives JAX's leaf order and `keystr` paths on nested
  trees (dicts in sorted key order, lists and tuples in order, `None` an
  empty subtree).
* Its MessagePack subset writes `msgpack.packb`'s bytes for the campaign
  manifests and edge values, and reads `msgpack`'s output back.
* Snapshots cross in both directions: one the reference wrote restores in
  the port (a bf16 leaf as `torch.bfloat16`, int64 / float64 search state
  exactly with `to_device=False`), and one the port wrote restores in the
  reference, with the same manifest.
* The reference's own cases, ported: roundtrip, retention, atomicity,
  background save, structure mismatch, truncation and a bit flip detected
  with the previous step loaded instead.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointManager,
)
from repro_torch.checkpoint import msgpack_lite  # noqa: E402
from repro_torch.checkpoint import tree as TU  # noqa: E402

CPU = "cpu"


def _state(seed=0):
    """The reference test's state as tensors: f32, bf16, f32 zeros, int32."""
    r = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           r.normal(0, 1, (8, 4)).astype(np.float32)),
                       "b": torch.from_numpy(r.normal(0, 1, (4,))
                                             .astype(np.float32))
                       .to(torch.bfloat16)},
            "opt": {"mu": torch.zeros((8, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _ref_state(seed=0):
    r = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(r.normal(0, 1, (8, 4)), jnp.float32),
                       "b": jnp.asarray(r.normal(0, 1, (4,)), jnp.bfloat16)},
            "opt": {"mu": jnp.zeros((8, 4)), "step": jnp.int32(7)}}


def _zeros_like(state):
    return {k: {n: torch.zeros_like(v) for n, v in d.items()}
            for k, d in state.items()}


def _search_state(seed=0, islands=3, P=6, G=5):
    """A campaign's checkpoint tree: int64 pops, float64 objectives."""
    r = np.random.default_rng(seed)
    return {"islands": [{"pop": r.integers(0, 9, (P, G)).astype(np.int64),
                         "F": r.random((P, 2))} for _ in range(islands)],
            "archive": {"X": r.integers(0, 9, (4, G)).astype(np.int64),
                        "F": r.random((4, 2))}}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "MANIFEST.msgpack"), "rb") as f:
        return f.read()


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# leaf order and paths, MessagePack
# ---------------------------------------------------------------------------
TREES = [
    _search_state(),
    {"b": (5, [6, {"q": 7, "a": 8}]), "a": None, "c": [], "d": {}},
    {"n": {2: 1, 1: 3, 10: 4}, "z": [[1, [2, (3,)]], None, 4]},
    [np.zeros(3), {"y": 1.0, "x": (None, 2)}],
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_flatten_order_and_paths_equal_jax(i):
    tree = TREES[i]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert TU.leaf_paths(tree) == [jax.tree_util.keystr(kp) for kp, _ in flat]
    assert all(a is b for a, b in zip(TU.leaves(tree),
                                      [leaf for _, leaf in flat]))
    rebuilt = TU.unflatten(tree, list(range(len(flat))))
    want = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), list(range(len(flat))))
    assert TU.leaf_paths(rebuilt) == TU.leaf_paths(want)
    assert TU.leaves(rebuilt) == TU.leaves(want)


def _campaign_manifest():
    from repro.core.nsga2 import encode_rng_state
    rngs = [np.random.default_rng(s) for s in (7, 9980, 19953)]
    for r in rngs:
        r.integers(0, 5, size=100)
    state = _search_state()
    return {"step": 3, "paths": TU.leaf_paths(state),
            "shapes": [list(np.shape(a)) for a in TU.leaves(state)],
            "dtypes": [str(np.asarray(a).dtype) for a in TU.leaves(state)],
            "extra": {"version": 1, "name": "tnn_cardio", "epoch": 3,
                      "rngs": [encode_rng_state(r) for r in rngs],
                      "generations": [20, 20, 20],
                      "histories": [[[g, 0.1 * g, 1.5 + g]
                                     for g in range(20)]] * 3,
                      "config": {"n_islands": 3, "seed": 7,
                                 "crossover_prob": 0.9, "dedup_eval": True,
                                 "mutation_prob": None}},
            "leaves_sha256": "ab" * 32}


EDGE_VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
               2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1,
               -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0, 1.5, 1e300,
               float("inf"), True, False, None, "", "x" * 31, "x" * 32,
               "é" * 200, "y" * 70000, list(range(15)),
               list(range(16)), list(range(70000)),
               {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
               {str(i): [i] for i in range(70000)}, (1, "a", (2.5,))]


@pytest.mark.parametrize("case", ["manifest", "edges"])
def test_msgpack_bytes_equal_msgpack(case):
    objs = [_campaign_manifest()] if case == "manifest" else EDGE_VALUES
    for obj in objs:
        mine = msgpack_lite.pack(obj)
        assert mine == msgpack.packb(obj)
        assert msgpack_lite.unpack(mine) == msgpack.unpackb(mine)
    assert msgpack_lite.unpack(msgpack.packb(_campaign_manifest())) == \
        msgpack.unpackb(msgpack.packb(_campaign_manifest()))
    with pytest.raises(ValueError):
        msgpack_lite.unpack(msgpack.packb(_campaign_manifest())[:-3])
    for unsupported in (object(), b"bytes"):
        with pytest.raises(TypeError):
            msgpack_lite.pack({"a": unsupported})


# ---------------------------------------------------------------------------
# snapshots across the two packages
# ---------------------------------------------------------------------------
def test_reference_snapshot_restores_in_the_port(tmp_path):
    RefManager(str(tmp_path)).save(4, _ref_state(3), extra={"loss": 1.25})
    step, got, extra = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(_state()), to_device=True, device=CPU)
    assert step == 4 and extra == {"loss": 1.25}
    want = _ref_state(3)
    assert got["params"]["b"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    for a, b in zip(TU.leaves(want), TU.leaves(got)):
        np.testing.assert_array_equal(_as_f32(b), _as_f32(a))
    # off the device: numpy with the saved dtypes, bf16 as a CPU tensor
    _, host, _ = CheckpointManager(str(tmp_path)).restore(
        {"params": {"w": np.zeros((8, 4), np.float32),
                    "b": torch.zeros(4, dtype=torch.bfloat16)},
         "opt": {"mu": np.zeros((8, 4), np.float32),
                 "step": np.int32(0)}}, to_device=False)
    assert isinstance(host["params"]["w"], np.ndarray)
    assert host["params"]["b"].dtype == torch.bfloat16
    assert host["opt"]["step"].dtype == np.int32


def test_port_snapshot_restores_in_the_reference(tmp_path):
    CheckpointManager(str(tmp_path)).save(2, _state(5), extra={"epoch": 2})
    step, got, extra = RefManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, _ref_state()))
    assert step == 2 and extra == {"epoch": 2}
    assert got["params"]["b"].dtype == jnp.bfloat16
    for a, b in zip(TU.leaves(_state(5)), jax.tree.leaves(got)):
        np.testing.assert_array_equal(_as_f32(b), _as_f32(a))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_search_state_crosses_exactly(tmp_path, writer):
    """int64 / float64 search state and the manifest bytes are the same
    whichever package wrote them."""
    state = _search_state(11)
    extra = _campaign_manifest()["extra"]
    RefManager(str(tmp_path / "r")).save(3, state, extra=extra)
    CheckpointManager(str(tmp_path / "p")).save(3, state, extra=extra)
    assert _manifest(tmp_path / "r", 3) == _manifest(tmp_path / "p", 3)
    src = tmp_path / ("r" if writer == "reference" else "p")
    template = _search_state(0)
    _, mine, ex_mine = CheckpointManager(str(src)).restore(
        template, to_device=False)
    _, ref, ex_ref = RefManager(str(src)).restore(template, to_device=False)
    assert ex_mine == ex_ref == extra
    for a, b, c in zip(TU.leaves(state), TU.leaves(mine), TU.leaves(ref)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    _, on_dev, _ = CheckpointManager(str(src)).restore(template, device=CPU)
    assert on_dev["islands"][0]["pop"].dtype == torch.int64
    assert on_dev["archive"]["F"].dtype == torch.float64


# ---------------------------------------------------------------------------
# the reference's cases, ported
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    cm.save(10, state, extra={"loss": 1.25})
    step, restored, extra = cm.restore(_zeros_like(state), device=CPU)
    assert step == 10 and extra["loss"] == 1.25
    for a, b in zip(TU.leaves(state), TU.leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_retention_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _state(s))
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_atomicity_no_tmp_left(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _state())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_background_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = _state()
    cm.save(1, state, background=True)
    state["params"]["w"].add_(1.0)         # the snapshot was taken already
    cm.wait()
    assert cm.latest_step() == 1
    _, got, _ = cm.restore(_zeros_like(state), device=CPU)
    torch.testing.assert_close(got["params"]["w"], _state()["params"]["w"],
                               rtol=0, atol=0)


def test_structure_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state())
    bad = {"params": {"w": torch.zeros((8, 4))}}   # missing leaves
    with pytest.raises(ValueError, match="structure mismatch"):
        cm.restore(bad, device=CPU)


def test_truncated_checkpoint_detected_and_previous_loaded(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, _state(1), extra={"epoch": 1})
    cm.save(2, _state(2), extra={"epoch": 2})
    leaves = os.path.join(tmp_path, "step_2", "leaves.npz")
    payload = open(leaves, "rb").read()
    with open(leaves, "wb") as f:
        f.write(payload[: len(payload) // 2])          # torn write
    assert not cm.validate(2) and cm.validate(1)
    assert cm.latest_valid_step() == 1
    assert RefManager(str(tmp_path)).latest_valid_step() == 1
    step, restored, extra = cm.restore(_zeros_like(_state()), device=CPU)
    assert step == 1 and extra["epoch"] == 1
    for a, b in zip(TU.leaves(_state(1)), TU.leaves(restored)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    with pytest.raises(CheckpointCorruptError):
        cm.restore(_zeros_like(_state()), step=2, device=CPU)


def test_bitflip_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state())
    leaves = os.path.join(tmp_path, "step_1", "leaves.npz")
    payload = bytearray(open(leaves, "rb").read())
    payload[len(payload) // 2] ^= 0xFF
    open(leaves, "wb").write(bytes(payload))
    assert not cm.validate(1)
    with pytest.raises(FileNotFoundError, match="no valid checkpoints"):
        cm.restore(_zeros_like(_state()), device=CPU)


def test_restore_without_device_needs_cuda(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _search_state())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm.restore(_search_state())
    cm.restore(_search_state(), to_device=False)     # the host needs none
