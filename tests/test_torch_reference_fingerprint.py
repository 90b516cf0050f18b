"""The fingerprints that stand in tier-1 for the JAX re-derivations of the
stored records (``jax_references.fingerprint``,
``mgbtpu_torch/data/ref_fingerprint.json``): every entry names a stored
record; the fingerprint moves with one byte of a source file of
``mgbtpu/``, and not with the build outputs ``.gitignore`` lists; a stale
entry fails, naming the slow test that re-derives the record.
"""
import json
import os
import shutil

import numpy as np
import pytest

import jax_references as JR


def test_every_entry_names_a_stored_record():
    with open(JR.FINGERPRINT) as f:
        entries = json.load(f)
    assert entries
    for key, entry in entries.items():
        fname, _, prefix = key.partition("/")
        with np.load(os.path.join(JR.DATA, fname)) as data:
            assert not prefix or any(k.startswith(prefix + "/")
                                     for k in data.files), key
        assert set(entry) == {"sha256", "extra", "jax", "jaxlib", "numpy"}
        for path in entry["extra"]:
            assert os.path.exists(os.path.join(JR.ROOT, path)), path


@pytest.fixture()
def copy_root(tmp_path, monkeypatch):
    """A copy of what a fingerprint reads, as the repository root."""
    shutil.copytree(os.path.join(JR.ROOT, "mgbtpu"), tmp_path / "mgbtpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    (tmp_path / "tests").mkdir()
    for f in ("jax_references.py", "conftest.py", "test_golden.py"):
        shutil.copy(os.path.join(JR.ROOT, "tests", f), tmp_path / "tests")
    monkeypatch.setattr(JR, "ROOT", str(tmp_path))
    monkeypatch.setattr(JR, "FINGERPRINT", str(tmp_path / "fp.json"))
    JR.fingerprint.cache_clear()
    yield tmp_path
    JR.fingerprint.cache_clear()


def test_a_source_byte_moves_the_fingerprint(copy_root):
    before = JR.fingerprint()
    extra = JR.fingerprint(("tests/test_golden.py",))
    assert extra["sha256"] != before["sha256"]
    # build outputs do not count
    (copy_root / "mgbtpu" / "native" / "built.so").write_bytes(b"\0")
    (copy_root / "mgbtpu" / "__pycache__").mkdir(exist_ok=True)
    (copy_root / "mgbtpu" / "__pycache__" / "x.pyc").write_bytes(b"\0")
    JR.fingerprint.cache_clear()
    assert JR.fingerprint() == before
    path = copy_root / "mgbtpu" / "solver" / "newton.py"
    path.write_bytes(path.read_bytes() + b" ")
    JR.fingerprint.cache_clear()
    assert JR.fingerprint()["sha256"] != before["sha256"]


def test_a_stale_entry_names_the_slow_test(copy_root):
    JR.write_fingerprint("ref_x.npz")
    JR.assert_fingerprint("ref_x.npz", "tests/t.py::slow_case")
    path = copy_root / "tests" / "conftest.py"
    path.write_bytes(path.read_bytes() + b"\n")
    JR.fingerprint.cache_clear()
    with pytest.raises(AssertionError, match="tests/t.py::slow_case"):
        JR.assert_fingerprint("ref_x.npz", "tests/t.py::slow_case")
    with pytest.raises(AssertionError, match="no fingerprint is stored"):
        JR.assert_fingerprint("ref_y.npz", "tests/t.py::other")
