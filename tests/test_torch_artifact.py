"""The port serves the committed reference-emitted bundles.

`tests/golden_emit/` holds the five golden classifiers written by the
reference's `save_program`/`register_tenant` (regenerate with
`tools/emit_golden_bundles.py`).  The port's reader must serve them with
the golden labels, refuse corrupt bundles and stale manifest rows exactly
as the reference does, and the committed arrays must still be what the
reference lowers today.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compile import artifact as RA  # noqa: E402
from repro.data.tabular import DATASETS  # noqa: E402
from repro_torch.compile import artifact as A  # noqa: E402
from test_golden import GOLDEN_DIR, golden_classifier  # noqa: E402

EMIT_DIR = Path(__file__).parent / "golden_emit"


def _row(name: str) -> dict:
    return next(r for r in A.load_manifest(EMIT_DIR) if r["name"] == name)


def test_manifest_lists_the_five_golden_tenants():
    doc = A.load_manifest_doc(EMIT_DIR)
    assert doc == RA.load_manifest_doc(EMIT_DIR)
    assert [r["name"] for r in doc["tenants"]] == sorted(DATASETS)
    with pytest.raises(FileNotFoundError):
        A.load_manifest(EMIT_DIR / "missing")


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_committed_bundle_serves_golden_labels(name):
    row = _row(name)
    path = EMIT_DIR / row["program"]
    prog = A.load_program(path, device="cpu", expect_sha256=row["sha256"])
    fix = np.load(GOLDEN_DIR / f"{name}.npz")
    np.testing.assert_array_equal(prog.predict(fix["x"]), fix["labels"])
    ref = RA.load_program(path)
    np.testing.assert_array_equal(prog.predict(fix["x"]),
                                  ref.predict(fix["x"]))
    assert (prog.ir.name, prog.n_classes) == (ref.ir.name, ref.n_classes)
    assert prog.ir.meta == ref.ir.meta


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_committed_bundle_equals_reference_lowering(name):
    """Array by array (npz bytes carry zip timestamps, so not by bytes)."""
    cc, _ = golden_classifier(name)
    with np.load(EMIT_DIR / _row(name)["program"]) as fix:
        header = json.loads(bytes(fix["header_json"]).decode())
        assert int(fix["n_inputs"]) == cc.ir.n_inputs
        for key in ("op", "in0", "in1", "outputs", "levels"):
            np.testing.assert_array_equal(fix[key], getattr(cc.ir, key),
                                          err_msg=key)
        np.testing.assert_array_equal(fix["thresholds"], cc.thresholds)
        assert sorted(header["taps"]) == sorted(cc.ir.taps)
        for key, tap in cc.ir.taps.items():
            np.testing.assert_array_equal(fix[f"tap_{key}"], tap)
    assert header["n_classes"] == cc.n_classes
    assert header["name"] == cc.ir.name


def _copy_bundle(tmp_path: Path, name: str = "cardio") -> Path:
    src = EMIT_DIR / _row(name)["program"]
    dst = tmp_path / src.name
    shutil.copy(src, dst)
    shutil.copy(src.with_name(src.name + A.SHA_SUFFIX),
                dst.with_name(dst.name + A.SHA_SUFFIX))
    return dst


def test_truncated_bundle_is_refused(tmp_path):
    path = _copy_bundle(tmp_path)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(A.ArtifactCorruptError, match="checksum"):
        A.load_program(path, device="cpu")


def test_bit_flipped_bundle_is_refused(tmp_path):
    path = _copy_bundle(tmp_path)
    data = bytearray(path.read_bytes())
    data[len(data) // 3] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(A.ArtifactCorruptError, match="checksum"):
        A.load_program(path, device="cpu")


def test_stale_manifest_sha_is_refused(tmp_path):
    path = _copy_bundle(tmp_path)
    stale = _row("redwine")["sha256"]
    with pytest.raises(A.ArtifactCorruptError, match="manifest"):
        A.load_program(path, device="cpu", expect_sha256=stale)
    with pytest.raises(A.ArtifactCorruptError, match="does not exist"):
        A.load_program(tmp_path / "gone.npz", device="cpu")


def test_undecodable_and_non_feed_forward_bundles(tmp_path):
    junk = tmp_path / "junk_program.npz"
    junk.write_bytes(b"not an npz")          # no sidecar: checksum skipped
    with pytest.raises(A.ArtifactCorruptError, match="cannot be decoded"):
        A.load_program(junk, device="cpu")
    with np.load(EMIT_DIR / _row("cardio")["program"]) as fix:
        arrays = {k: fix[k] for k in fix.files}
    arrays["in0"] = arrays["in0"].copy()
    arrays["in0"][0] = int(arrays["n_inputs"]) + 5
    bad = tmp_path / "bad_program.npz"
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="feed-forward"):
        A.load_program(bad, device="cpu")
