"""Servable program bundles and the fleet manifest, written and read.

The port of `repro.compile.artifact`: the same compressed npz bundles
(integer IR arrays, float64 ABC thresholds, a JSON header), the same
`<bundle>.sha256` sidecars and the same `fleet.json` manifest.
`save_program` writes the reference's keys in the reference's order and
dtypes, and the header with `json.dumps(..., sort_keys=True)`, so a
classifier the port lowers is saved with the bytes (and the sha256) the
reference writes for it.  `register_tenant` adds or replaces one row of
the manifest and bumps its generation.  `load_program` refuses a
truncated or bit-flipped bundle, or one whose digest disagrees with the
manifest row that named it, with `ArtifactCorruptError`, and a bundle
that is not feed-forward with `ValueError`, before anything runs on the
device.

`program_from_arrays` is where a reference design crosses into the port:
it builds a `CircuitProgram` from the reference `CircuitIR` /
`CompiledClassifier` fields given as plain numpy arrays.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from repro_torch.compile.ir import CircuitIR, CompiledClassifier
from repro_torch.compile.program import CircuitProgram

MANIFEST_NAME = "fleet.json"
MANIFEST_VERSION = 1
PROGRAM_SUFFIX = "_program.npz"
SHA_SUFFIX = ".sha256"


class ArtifactCorruptError(RuntimeError):
    """A program bundle failed its sha256 (truncated/bit-flipped on disk)."""


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_program(cc: CompiledClassifier, path: str | Path) -> str:
    """Write the servable slice of a `CompiledClassifier` as one npz.

    A `<path>.sha256` sidecar records the bundle digest (written only
    after the payload it vouches for), so `load_program` can detect
    corruption.
    """
    ir = cc.ir
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "version": MANIFEST_VERSION,
        "name": ir.name,
        "meta": ir.meta,
        "taps": sorted(ir.taps),
        "n_classes": cc.n_classes,
        "score_bits": cc.score_bits,
    }
    arrays = {
        "n_inputs": np.int64(ir.n_inputs),
        "op": ir.op,
        "in0": ir.in0,
        "in1": ir.in1,
        "outputs": ir.outputs,
        "levels": ir.levels,
        "thresholds": np.asarray(cc.thresholds, dtype=np.float64),
        "header_json": np.frombuffer(
            json.dumps(header, sort_keys=True).encode(), dtype=np.uint8),
    }
    for key in header["taps"]:
        arrays[f"tap_{key}"] = ir.taps[key]
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(path)
    path.with_name(path.name + SHA_SUFFIX).write_text(digest + "\n")
    return str(path)


def verify_program_bundle(path: str | Path,
                          expect_sha256: str | None = None) -> str | None:
    """Check `path` against its sha256 sidecar; returns the digest.

    Returns None when neither a sidecar nor `expect_sha256` exists (a
    bundle from before checksums, accepted as the reference accepts it);
    raises `ArtifactCorruptError` on any mismatch or a missing bundle.
    `expect_sha256` is the digest an external record (a manifest row)
    claims for this bundle, cross-checked against the actual file.
    """
    path = Path(path)
    sidecar = path.with_name(path.name + SHA_SUFFIX)
    if not path.exists():
        raise ArtifactCorruptError(f"program bundle {path} does not exist")
    if not sidecar.exists() and expect_sha256 is None:
        return None
    got = _sha256_file(path)
    if sidecar.exists():
        want = sidecar.read_text().strip()
        if got != want:
            raise ArtifactCorruptError(
                f"program bundle {path} fails its checksum "
                f"(sha256 {got[:12]}… != recorded {want[:12]}…) — the bundle "
                "was truncated or corrupted on disk; re-emit the artifact")
    if expect_sha256 is not None and got != expect_sha256.strip():
        raise ArtifactCorruptError(
            f"program bundle {path} does not match the manifest row that "
            f"references it (sha256 {got[:12]}… != manifest "
            f"{expect_sha256.strip()[:12]}…) — the row is stale or "
            "tampered; re-emit the artifact")
    return got


def program_from_arrays(arrays: dict, n_classes: int | None, device=None,
                        name: str = "", meta: dict | None = None
                        ) -> CircuitProgram:
    """Build a program from the reference IR fields as numpy arrays.

    `arrays` holds `n_inputs`, `op`, `in0`, `in1`, `outputs`, `levels`,
    `thresholds` (None for a bare circuit) and `taps` (a dict of named
    node-id arrays).  Raises `ValueError` if the gate array is not
    feed-forward.
    """
    ir = CircuitIR(
        n_inputs=int(arrays["n_inputs"]),
        op=np.asarray(arrays["op"]).astype(np.int16),
        in0=np.asarray(arrays["in0"]).astype(np.int32),
        in1=np.asarray(arrays["in1"]).astype(np.int32),
        outputs=np.asarray(arrays["outputs"]).astype(np.int32),
        levels=np.asarray(arrays["levels"]).astype(np.int32),
        taps={k: np.asarray(v).astype(np.int32)
              for k, v in arrays.get("taps", {}).items()},
        name=name,
        meta=dict(meta or {}),
    )
    thresholds = arrays.get("thresholds")
    return CircuitProgram(
        ir=ir, n_classes=n_classes, device=device,
        thresholds=(None if thresholds is None
                    else np.asarray(thresholds, dtype=np.float64)))


def load_program(path: str | Path, device=None,
                 expect_sha256: str | None = None) -> CircuitProgram:
    """Rebuild a classifier `CircuitProgram` from a reference bundle.

    Validates the bundle against its sha256 sidecar (and `expect_sha256`,
    when a manifest row supplies one) before decoding it.
    """
    path = Path(path)
    verify_program_bundle(path, expect_sha256=expect_sha256)
    try:
        with np.load(path) as fix:
            header = json.loads(bytes(fix["header_json"]).decode())
            arrays = {k: fix[k] for k in ("n_inputs", "op", "in0", "in1",
                                          "outputs", "levels", "thresholds")}
            arrays["taps"] = {k: fix[f"tap_{k}"] for k in header["taps"]}
    except Exception as exc:   # an unreadable archive that passed (or had no)
        raise ArtifactCorruptError(          # checksum is still corruption
            f"program bundle {path} cannot be decoded "
            f"({type(exc).__name__}: {exc}) — re-emit the artifact") from exc
    return program_from_arrays(arrays, header["n_classes"], device=device,
                               name=header["name"], meta=header["meta"])


# -- fleet manifest ---------------------------------------------------------
def manifest_path(emit_dir: str | Path) -> Path:
    return Path(emit_dir) / MANIFEST_NAME


def load_manifest_doc(emit_dir: str | Path) -> dict:
    """The full manifest document: version, generation, sorted tenant rows."""
    path = manifest_path(emit_dir)
    if not path.exists():
        raise FileNotFoundError(f"no {MANIFEST_NAME} under {emit_dir}")
    doc = json.loads(path.read_text())
    if doc.get("version") != MANIFEST_VERSION:
        raise ValueError(f"unsupported manifest version {doc.get('version')}")
    doc.setdefault("generation", 0)
    doc["tenants"] = sorted(doc["tenants"], key=lambda t: t["name"])
    return doc


def load_manifest(emit_dir: str | Path) -> list[dict]:
    """Tenant rows of `emit_dir`'s fleet manifest (sorted by name)."""
    return load_manifest_doc(emit_dir)["tenants"]


def register_tenant(emit_dir: str | Path, entry: dict) -> Path:
    """Add/replace one tenant row in `emit_dir`'s manifest (atomic write).

    `entry` must carry at least name/program; paths are stored relative to
    the emit dir so the directory can be tarred up and served elsewhere.
    Every call bumps the manifest's generation counter and stamps the row
    with it — a live fleet watching the file reloads exactly the rows
    whose generation moved.
    """
    if "name" not in entry or "program" not in entry:
        raise ValueError("manifest entry needs at least name + program")
    emit_dir = Path(emit_dir)
    emit_dir.mkdir(parents=True, exist_ok=True)
    path = manifest_path(emit_dir)
    tenants, generation = [], 0
    if path.exists():
        doc = json.loads(path.read_text())
        generation = int(doc.get("generation", 0))
        tenants = [t for t in doc.get("tenants", [])
                   if t["name"] != entry["name"]]
    generation += 1
    entry = {k: (os.path.relpath(v, emit_dir)
                 if k in ("program", "verilog", "report") else v)
             for k, v in entry.items()}
    entry["generation"] = generation
    tenants.append(entry)
    doc = {"version": MANIFEST_VERSION, "generation": generation,
           "tenants": sorted(tenants, key=lambda t: t["name"])}
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return path
