"""Content-addressed on-disk cache for Phase-1/2 pipeline products.

The port of `repro.evolve.phase_cache`.  `build_tnn_problem` runs the
paper's whole producer pipeline — TNN quantization-aware training, CGP
evolution of approximate popcount libraries, and the Pareto PCC library
build — before a single NSGA-II generation happens.  The pipeline is
deterministic in ``(dataset, seed, budgets, device type)``, yet every
caller would pay it again: each autopilot round in a fresh process, every
zoo sweep entry, every spawned island worker.  This module persists the
three products

  * the trained ternary network (``TrainedTNN`` weight codes + ABC
    thresholds + recorded accuracies),
  * the per-size approximate PC libraries (lists of ``Netlist``),
  * the Pareto PCC library (``PCCLibrary`` of PC-pair entries) and the
    output-neuron Pareto PC list,

under a sha256 key of every input the pipeline's output depends on, in
`checkpoint.manager` style: one npz payload written via tmp + rename,
fsynced, with a sha256 sidecar recorded only after the payload it
vouches for is durable.  A truncated or bit-flipped entry raises
`PhaseCacheCorruptError` on load — callers rebuild loudly (warn +
recompute + rewrite) instead of silently serving garbage circuits.

The entry format is the reference's byte for byte, but the key is the
port's own: it adds ``"framework": "torch"`` and the device type the
pipeline ran on, because the port's QAT is not bit-identical to the
reference's on every dataset, nor the card's to the CPU's.  So the port
never loads a product of the other framework or device type by accident;
`load_phase(root, key)` still reads any entry named explicitly by its key,
which is how the reference's products reach the port's campaigns
(`build_tnn_problem(phase_key=...)`).

The cache directory resolves from ``REPRO_TORCH_PHASE_CACHE`` (set it to
``off`` / ``0`` / empty to disable caching entirely), falling back to
``~/.cache/repro_torch/phase_cache``.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

import torch

from repro_torch.core.circuits import Netlist
from repro_torch.core.pcc import PCCEntry, PCCLibrary
from repro_torch.core.tnn import TrainedTNN

# Bump when the Phase-1/2 pipeline changes in a way that affects its
# products — stale entries then simply miss instead of poisoning builds.
PHASE_CACHE_VERSION = 1
_SUFFIX = ".npz"
_SHA_SUFFIX = ".sha256"
_DISABLED = {"off", "0", "false", "no", ""}


class PhaseCacheCorruptError(RuntimeError):
    """A cache entry failed its checksum or cannot be decoded."""


def phase_key(dataset: str, seed: int, epochs: int, cgp_points: int,
              cgp_iters: int, pcc_samples: int, device=None) -> str:
    """sha256 over every input the Phase-1/2 products depend on: the
    reference's fields, the framework, and the type of `device` the
    pipeline runs on (None: the card, ``"cuda"``)."""
    blob = json.dumps({
        "version": PHASE_CACHE_VERSION,
        "framework": "torch",
        "device": "cuda" if device is None else torch.device(device).type,
        "dataset": dataset,
        "seed": int(seed),
        "epochs": int(epochs),
        "cgp_points": int(cgp_points),
        "cgp_iters": int(cgp_iters),
        "pcc_samples": int(pcc_samples),
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def default_cache_dir() -> Path | None:
    """Resolve the cache root (None = caching disabled via env)."""
    env = os.environ.get("REPRO_TORCH_PHASE_CACHE")
    if env is not None:
        if env.strip().lower() in _DISABLED:
            return None
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "phase_cache"


def entry_path(cache_dir: str | Path, key: str) -> Path:
    return Path(cache_dir) / f"phase_{key}{_SUFFIX}"


# -- (de)serialization -------------------------------------------------------
def _pack_netlist(arrays: dict, prefix: str, nl: Netlist) -> dict:
    arrays[f"{prefix}_op"] = np.asarray(nl.op, dtype=np.int16)
    arrays[f"{prefix}_in0"] = np.asarray(nl.in0, dtype=np.int32)
    arrays[f"{prefix}_in1"] = np.asarray(nl.in1, dtype=np.int32)
    arrays[f"{prefix}_out"] = np.asarray(nl.outputs, dtype=np.int32)
    return {"n_inputs": int(nl.n_inputs), "name": nl.name, "meta": nl.meta}


def _unpack_netlist(fix, prefix: str, header: dict) -> Netlist:
    return Netlist(n_inputs=int(header["n_inputs"]),
                   op=fix[f"{prefix}_op"].astype(np.int16),
                   in0=fix[f"{prefix}_in0"].astype(np.int32),
                   in1=fix[f"{prefix}_in1"].astype(np.int32),
                   outputs=fix[f"{prefix}_out"].astype(np.int32),
                   name=str(header["name"]), meta=dict(header["meta"]))


def save_phase(cache_dir: str | Path, key: str, tnn: TrainedTNN,
               pc_libs: dict[int, list[Netlist]], pcc_lib: PCCLibrary,
               pc_out: list[Netlist]) -> Path:
    """Persist one pipeline run's products atomically under `key`."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = entry_path(cache_dir, key)

    arrays: dict[str, np.ndarray] = {
        "tnn_w1t": np.asarray(tnn.w1t, dtype=np.int8),
        "tnn_w2t": np.asarray(tnn.w2t, dtype=np.int8),
        "tnn_thresholds": np.asarray(tnn.thresholds, dtype=np.float64),
        "tnn_acc": np.array([tnn.train_acc, tnn.test_acc], dtype=np.float64),
    }
    header: dict = {"version": PHASE_CACHE_VERSION, "key": key,
                    "tnn_name": tnn.name, "pc_libs": {}, "pcc": [],
                    "pc_out": []}
    for n, nls in sorted(pc_libs.items()):
        header["pc_libs"][str(n)] = [
            _pack_netlist(arrays, f"pc{n}_{i}", nl)
            for i, nl in enumerate(nls)]
    for e, (size, entries) in enumerate(sorted(pcc_lib.entries.items())):
        for i, ent in enumerate(entries):
            header["pcc"].append({
                "n_pos": int(ent.n_pos), "n_neg": int(ent.n_neg),
                "pos": _pack_netlist(arrays, f"pcc{e}_{i}_p", ent.pc_pos),
                "neg": _pack_netlist(arrays, f"pcc{e}_{i}_n", ent.pc_neg),
                "prefix": f"pcc{e}_{i}",
            })
            arrays[f"pcc{e}_{i}_stats"] = np.array(
                [ent.est_area, ent.mde, ent.wcde, ent.correct_frac],
                dtype=np.float64)
    header["pc_out"] = [_pack_netlist(arrays, f"out_{i}", nl)
                        for i, nl in enumerate(pc_out)]
    arrays["header_json"] = np.frombuffer(
        json.dumps(header, sort_keys=True, default=_json_scalar).encode(),
        dtype=np.uint8)

    # pid-unique tmp names: concurrent writers of the SAME key (zoo
    # workers whose entries share phase products) must not clobber each
    # other's in-flight tmp file — each rename lands a complete payload,
    # last writer wins, both are byte-valid for this key.  A racing
    # payload/sidecar interleave can pair one writer's payload with the
    # other's digest; a reader in that window gets the *loud* corrupt
    # path (drop + rebuild), never a silently wrong product.
    tmp = path.with_name(f".tmp-{os.getpid()}-{path.name}")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(tmp)
    os.replace(tmp, path)
    sidecar = path.with_name(path.name + _SHA_SUFFIX)
    tmp_sc = sidecar.with_name(f".tmp-{os.getpid()}-{sidecar.name}")
    tmp_sc.write_text(digest + "\n")
    os.replace(tmp_sc, sidecar)
    return path


def load_phase(cache_dir: str | Path, key: str
               ) -> tuple[TrainedTNN, dict[int, list[Netlist]], PCCLibrary,
                          list[Netlist]]:
    """Load one entry; FileNotFoundError on miss, corruption is loud."""
    path = entry_path(cache_dir, key)
    if not path.exists():
        raise FileNotFoundError(f"no phase-cache entry for {key[:12]}… "
                                f"under {cache_dir}")
    sidecar = path.with_name(path.name + _SHA_SUFFIX)
    if not sidecar.exists():
        raise PhaseCacheCorruptError(
            f"phase-cache entry {path} has no sha256 sidecar — the write "
            "was interrupted; rebuilding")
    want = sidecar.read_text().strip()
    got = _sha256_file(path)
    if got != want:
        raise PhaseCacheCorruptError(
            f"phase-cache entry {path} fails its checksum (sha256 "
            f"{got[:12]}… != recorded {want[:12]}…) — truncated or "
            "bit-flipped on disk; rebuilding")
    try:
        with np.load(path) as fix:
            header = json.loads(bytes(fix["header_json"]).decode())
            acc = fix["tnn_acc"]
            tnn = TrainedTNN(w1t=fix["tnn_w1t"].astype(np.int8),
                             w2t=fix["tnn_w2t"].astype(np.int8),
                             thresholds=fix["tnn_thresholds"].astype(
                                 np.float64),
                             train_acc=float(acc[0]), test_acc=float(acc[1]),
                             name=str(header["tnn_name"]))
            pc_libs = {int(n): [_unpack_netlist(fix, f"pc{n}_{i}", h)
                                for i, h in enumerate(hs)]
                       for n, hs in header["pc_libs"].items()}
            pcc = PCCLibrary()
            for row in header["pcc"]:
                stats = fix[f"{row['prefix']}_stats"]
                ent = PCCEntry(
                    n_pos=int(row["n_pos"]), n_neg=int(row["n_neg"]),
                    pc_pos=_unpack_netlist(fix, f"{row['prefix']}_p",
                                           row["pos"]),
                    pc_neg=_unpack_netlist(fix, f"{row['prefix']}_n",
                                           row["neg"]),
                    est_area=float(stats[0]), mde=float(stats[1]),
                    wcde=float(stats[2]), correct_frac=float(stats[3]))
                pcc.entries.setdefault((ent.n_pos, ent.n_neg), []).append(ent)
            pc_out = [_unpack_netlist(fix, f"out_{i}", h)
                      for i, h in enumerate(header["pc_out"])]
    except PhaseCacheCorruptError:
        raise
    except Exception as exc:  # checksum passed but the archive won't decode
        raise PhaseCacheCorruptError(
            f"phase-cache entry {path} cannot be decoded "
            f"({type(exc).__name__}: {exc}); rebuilding") from exc
    return tnn, pc_libs, pcc, pc_out


def drop_entry(cache_dir: str | Path, key: str) -> None:
    """Remove one entry (payload + sidecar), tolerating absence."""
    path = entry_path(cache_dir, key)
    for p in (path, path.with_name(path.name + _SHA_SUFFIX)):
        try:
            p.unlink()
        except FileNotFoundError:
            pass


def _json_scalar(v):
    """Netlist meta dicts may carry numpy scalars — map them to exact
    Python equivalents (np.float64 -> float is lossless)."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    raise TypeError(f"unserializable meta value {v!r} ({type(v).__name__})")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
