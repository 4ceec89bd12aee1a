"""Checkpointing: atomic, validated, retained, background-capable.

The port of `repro.checkpoint.manager`, on the reference's on-disk layout,
so a snapshot either package wrote restores in the other:

  * atomicity  — write into `<dir>/.tmp-<step>`, fsync every file, then
    `os.rename` to `<dir>/step_<N>` (atomic on POSIX); a crash mid-save
    never corrupts the latest checkpoint;
  * validation — the manifest records a sha256 of the leaf payload, written
    *after* the payload is durable; `restore()` verifies it, and a snapshot
    truncated or bit-flipped mid-write is detected instead of half-loaded.
    With `step=None` restore walks newest -> oldest and falls back to the
    most recent *valid* snapshot (the SIGKILL-mid-save story of a campaign
    resume);
  * manifest   — `MANIFEST.msgpack` with step, leaf paths, shapes, dtypes
    and the caller's `extra`, in JAX's leaf order and `keystr` paths
    (`checkpoint.tree`), encoded by `checkpoint.msgpack_lite`; leaves are
    stored as raw bytes in one `leaves.npz` keyed `leaf_<i>`;
  * retention  — keep the most recent `keep` checkpoints;
  * background — `save(..., background=True)` copies every leaf to host
    memory synchronously and writes to disk on a thread.

Each payload crosses the disk once a save and once a restore: a save
builds `leaves.npz` in memory, hashes it while writing it (both release
the interpreter lock), and a restore reads the file once, checks its
hash and loads the leaves from the bytes read.  The bytes on disk are
what `np.savez` writes to a file; this costs host memory of about twice
the payload, in place of a second pass over the disk.

Leaves are numpy arrays, tensors (on any device) or scalars.  `bfloat16`
leaves travel as their 16 raw bits under the dtype name `bfloat16`, as the
reference's `ml_dtypes` arrays do, and come back as `torch.bfloat16`.
The reference's `restore(mesh=, specs=)` resharding is not ported: the
port restores onto one device.
"""
from __future__ import annotations

import hashlib
import io
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.checkpoint import tree as TU
from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A specific requested snapshot failed validation."""


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """`(raw array, dtype name)`: bf16 tensors as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _placed(val, want, to_device: bool, dev):
    """A restored leaf cast to the template's dtype `want` (None: kept as
    saved), as a tensor on `dev` or, off the device, as numpy (a bf16 leaf
    stays a CPU tensor)."""
    if isinstance(want, torch.dtype):
        val = torch.as_tensor(val).to(want)
    elif want is not None and val.dtype != want:
        if isinstance(val, torch.Tensor):
            val = val.float().numpy()
        val = val.astype(want)
    if to_device:
        return torch.as_tensor(val).to(dev)
    if isinstance(val, torch.Tensor) and val.dtype != torch.bfloat16:
        return val.numpy()
    return val


def _template_dtype(leaf: Any):
    """The dtype a template leaf asks for (None: keep the saved one)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    if hasattr(leaf, "dtype"):
        return np.dtype(leaf.dtype)
    return None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- discovery -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "MANIFEST.msgpack")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             background: bool = False) -> None:
        flat = TU.flatten_with_paths(state)
        host = [_to_host(leaf) for _, leaf in flat]      # device -> host
        arrays = [a for a, _ in host]
        manifest = {
            "step": int(step),
            "paths": [p for p, _ in flat],
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [dt for _, dt in host],
            "extra": extra or {},
        }
        if background:
            self.wait()
            arrays = [np.array(a, copy=True) for a in arrays]
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, manifest)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: list[np.ndarray],
               manifest: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        buf = io.BytesIO()
        np.savez(buf, **{f"leaf_{i}": np.ascontiguousarray(a).view(np.uint8)
                         for i, a in enumerate(arrays)})
        payload = buf.getbuffer()
        digest = hashlib.sha256()
        hasher = threading.Thread(target=digest.update, args=(payload,))
        hasher.start()                  # hashes while the payload is written
        try:
            with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
        finally:
            hasher.join()
        manifest["leaves_sha256"] = digest.hexdigest()
        del payload
        buf.close()
        # manifest lands only after the payload it vouches for is durable
        with open(os.path.join(tmp, "MANIFEST.msgpack"), "wb") as f:
            f.write(msgpack_lite.pack(manifest))
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)                      # persist the rename itself
            finally:
                os.close(dfd)
        except OSError:
            pass
        self._retain()

    # -- validation ----------------------------------------------------------
    def _manifest(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step}", "MANIFEST.msgpack")
        with open(path, "rb") as f:
            return msgpack_lite.unpack(f.read())

    def _valid_payload(self, step: int) -> tuple[dict, bytes] | None:
        """`(manifest, leaves.npz bytes)` of snapshot `step` if it is
        complete and passes its checksum, else None."""
        d = os.path.join(self.dir, f"step_{step}")
        try:
            manifest = self._manifest(step)
            with open(os.path.join(d, "leaves.npz"), "rb") as f:
                payload = f.read()
            want = manifest.get("leaves_sha256")
            if want is not None:
                ok = hashlib.sha256(payload).hexdigest() == want
            else:
                # pre-checksum snapshot: at least require a loadable archive
                np.load(io.BytesIO(payload)).close()
                ok = True
            return (manifest, payload) if ok else None
        except Exception:   # noqa: BLE001 — any decode failure is "invalid"
            return None

    def validate(self, step: int) -> bool:
        """True iff snapshot `step` is complete and passes its checksum."""
        return self._valid_payload(step) is not None

    def latest_valid_step(self) -> int | None:
        for s in reversed(self.all_steps()):
            if self.validate(s):
                return s
        return None

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, template: Any, step: int | None = None,
                to_device: bool = True,
                device=None) -> tuple[int, Any, dict]:
        """Restore into the structure of `template`.

        `step=None` picks the newest snapshot that passes validation (a
        truncated or corrupt latest snapshot is skipped, falling back to
        its predecessor); an explicit `step` that fails validation raises
        `CheckpointCorruptError`.  Each leaf is cast to its template
        leaf's dtype where that differs.  `to_device=False` returns numpy
        arrays with the exact saved dtypes (`bfloat16` leaves as CPU
        `torch.bfloat16` tensors, which numpy cannot hold); otherwise every
        leaf is a tensor on `device` (None: the current CUDA device)."""
        if step is None:
            found = None
            for s in reversed(self.all_steps()):
                found = self._valid_payload(s)
                if found is not None:
                    break
            if found is None:
                raise FileNotFoundError(
                    f"no valid checkpoints under {self.dir}")
        else:
            found = self._valid_payload(step)
            if found is None:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} under {self.dir} is missing or "
                    "fails its checksum")
        manifest, payload = found
        flat = TU.flatten_with_paths(template)
        saved_paths = manifest["paths"]
        tmpl_paths = [p for p, _ in flat]
        if saved_paths != tmpl_paths:
            raise ValueError(
                "checkpoint/template structure mismatch: "
                f"{set(saved_paths) ^ set(tmpl_paths)}")
        dev = resolve_device(device) if to_device else None
        out = []
        with np.load(io.BytesIO(payload)) as data:
            for i, (_, leaf) in enumerate(flat):
                raw = data[f"leaf_{i}"]
                shape = tuple(manifest["shapes"][i])
                dt = manifest["dtypes"][i]
                if dt == _BF16:
                    val = torch.from_numpy(raw.view(np.int16).reshape(shape)
                                           .copy()).view(torch.bfloat16)
                else:
                    val = raw.view(np.dtype(dt)).reshape(shape).copy()
                out.append(_placed(val, _template_dtype(leaf), to_device,
                                   dev))
        return (int(manifest["step"]), TU.unflatten(template, out),
                manifest.get("extra", {}))
