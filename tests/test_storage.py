"""Pluggable storage layer (runtime/storage.py — modules/io/path.h analog).

The data plane (run manifests, stage done-checks, multi-host exchange
files) resolves every path through the scheme registry, so these tests
register an in-memory backend and drive the REAL StageRunner through it —
proving a new storage scheme needs zero pipeline changes."""

import io
import json

import numpy as np
import pytest

from biograph_jax.runtime import storage


class MemStorage(storage.Storage):
    """Dict-backed object store for tests."""

    def __init__(self, blobs):
        self.blobs = blobs

    def open(self, path, mode="r"):
        if "r" in mode:
            data = self.blobs[path]
            return io.BytesIO(data) if "b" in mode else io.StringIO(data.decode())
        blobs = self.blobs
        buf = io.BytesIO() if "b" in mode else io.StringIO()

        class _W:
            def __enter__(self):
                return buf

            def __exit__(self, *exc):
                if not any(exc):
                    data = buf.getvalue()
                    blobs[path] = data.encode() if isinstance(data, str) else data

        return _W()

    def exists(self, path):
        return path in self.blobs

    def makedirs(self, path):
        pass

    def publish(self, tmp, dst):
        self.blobs[dst] = self.blobs.pop(tmp)

    def listdir(self, path):
        pre = path.rstrip("/") + "/"
        return [k[len(pre):] for k in self.blobs if k.startswith(pre)]


@pytest.fixture
def mem():
    blobs = {}
    storage.register_scheme("mem", lambda: MemStorage(blobs))
    yield blobs
    storage._SCHEMES.pop("mem", None)
    storage._CACHE.pop("mem", None)


def test_scheme_dispatch_and_json_roundtrip(mem):
    path = "mem://bucket/a/b.json"
    storage.write_json_atomic(path, {"x": 1})
    assert storage.read_json(path) == {"x": 1}
    assert not any(k.endswith(".tmp") for k in mem)  # publish consumed tmp
    assert storage.scheme_of(path) == "mem"
    assert storage.scheme_of("/plain/path") == ""
    assert storage.join("mem://b/dir", "f.txt") == "mem://b/dir/f.txt"
    with pytest.raises(ValueError):
        storage.for_path("gs://nope/x")


def test_stage_runner_on_custom_scheme(mem):
    """The REAL StageRunner runs a two-stage pipeline entirely against the
    registered backend: manifest, resume skip, and artifact done-checks all
    go through the scheme."""
    from biograph_jax.runtime.stages import Stage, StageRunner

    run_dir = "mem://runs/r1"
    calls = []

    def s1(runner):
        calls.append("s1")
        with storage.for_path(run_dir).open(
            storage.join(run_dir, "one.txt"), "w"
        ) as f:
            f.write("hello")

    def s2(runner):
        calls.append("s2")

    stages = [
        Stage(name="one", fn=s1, outputs=[storage.join(run_dir, "one.txt")]),
        Stage(name="two", fn=s2),
    ]
    StageRunner(run_dir, resume=False).run(stages)
    assert calls == ["s1", "s2"]
    man = storage.read_json(storage.join(run_dir, "run_manifest.json"))
    assert man["stages"]["one"]["status"] == "done"
    # resume: done stages skip through the scheme's exists() checks
    r2 = StageRunner(run_dir, resume=True)
    r2.run(stages)
    assert calls == ["s1", "s2"]


def test_local_storage_binary_npz(tmp_path):
    st = storage.for_path(str(tmp_path))
    p = storage.join(str(tmp_path), "x.npz")
    with st.open(p + ".tmp", "wb") as f:
        np.savez(f, a=np.arange(5))
    st.publish(p + ".tmp", p)
    with st.open(p, "rb") as f:
        z = dict(np.load(f))
    np.testing.assert_array_equal(z["a"], np.arange(5))


def test_s3_unavailable_is_a_clear_error():
    with pytest.raises((RuntimeError, Exception)) as ei:
        storage.for_path("s3://bucket/key")
    storage._CACHE.pop("s3", None)
