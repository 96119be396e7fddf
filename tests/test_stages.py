import os

import pytest

from biograph_jax.runtime.stages import Stage, StageError, StageRunner


def test_stages_run_and_resume(tmp_path):
    run = str(tmp_path / "run")
    calls = []

    def mk(name):
        out = os.path.join(run, name + ".out")

        def fn(r):
            calls.append(name)
            open(out, "w").write(name)

        return Stage(name=name, fn=fn, outputs=[out])

    stages = [mk("a"), mk("b"), mk("c")]
    StageRunner(run).run(stages)
    assert calls == ["a", "b", "c"]

    # resume: nothing re-runs
    calls.clear()
    StageRunner(run).run(stages)
    assert calls == []

    # delete one output: only that stage re-runs
    os.remove(os.path.join(run, "b.out"))
    calls.clear()
    StageRunner(run).run(stages)
    assert calls == ["b"]


def test_stage_retry_and_failure(tmp_path):
    run = str(tmp_path / "run")
    attempts = {"n": 0}

    def flaky(r):
        attempts["n"] += 1
        if attempts["n"] < 2:
            raise RuntimeError("transient")
        open(os.path.join(run, "f.out"), "w").write("ok")

    s = Stage("flaky", flaky, outputs=[os.path.join(run, "f.out")], max_attempts=3)
    StageRunner(run).run([s])
    assert attempts["n"] == 2

    def always_fails(r):
        raise RuntimeError("boom")

    with pytest.raises(StageError):
        StageRunner(str(tmp_path / "run2")).run(
            [Stage("bad", always_fails, max_attempts=2)]
        )


def test_stop_after(tmp_path):
    run = str(tmp_path / "run")
    calls = []
    stages = [
        Stage(n, (lambda n: lambda r: calls.append(n))(n)) for n in ("x", "y", "z")
    ]
    StageRunner(run).run(stages, stop_after="y")
    assert calls == ["x", "y"]


def test_config_layering(monkeypatch, tmp_path):
    """Config singleton analog: defaults < product json < env < CLI."""
    from biograph_jax.runtime.config import apply_options
    from biograph_jax.variants.discover import DiscoverOptions

    prod = tmp_path / "product.json"
    prod.write_text('{"beam_width": 64, "max_path": 100}')
    monkeypatch.setenv("BGT_CONFIG", str(prod))
    monkeypatch.setenv("BGT_OPT_MAX_PATH", "200")
    opt = DiscoverOptions()
    applied = apply_options(opt, ["rejoin_k=21", "bidir=false"])
    assert opt.beam_width == 64  # product file
    assert opt.max_path == 200  # env beats product
    assert opt.rejoin_k == 21 and opt.bidir is False  # cli beats all
    assert applied["max_path"] == (200, "env")
    import pytest as _pytest

    with _pytest.raises(ValueError):
        apply_options(DiscoverOptions(), ["no_such_knob=1"])


def test_artifact_manifest_and_profiles(tmp_path):
    from biograph_jax.runtime.stages import ArtifactInfo, Stage, StageRunner

    run = tmp_path / "run"
    out1 = tmp_path / "a.bin"

    def make(runner):
        out1.write_bytes(b"x" * 100)
        runner.register_artifact("reads", str(out1), records=10)

    r = StageRunner(str(run), resume=True)
    r.run(
        [
            Stage("make", make, outputs=[str(out1)], profile="host"),
        ]
    )
    import json as _json

    m = _json.load(open(run / "run_manifest.json"))
    assert m["stages"]["make"]["profile"] == "host"
    assert m["stages"]["make"]["outputs"][0]["bytes"] == 100
    assert m["datasets"]["reads"]["records"] == 10
    assert ArtifactInfo.describe(str(out1)).bytes == 100


def test_container_codec_roundtrip(tmp_path):
    """zlib-coded parts must round-trip exactly and coexist with raw parts
    (reference codec-layer analog, modules/io/zip_slice.h)."""
    import numpy as np

    from biograph_jax.core.container import ArtifactReader, ArtifactWriter

    p = str(tmp_path / "a.bgt")
    mask = np.zeros(100000, bool)
    mask[500:700] = True
    mat = np.arange(600, dtype=np.int64).reshape(20, 30)
    with ArtifactWriter(p, "t") as w:
        w.add_array("mask", mask, codec="zlib")
        w.add_array("mat", mat)
        with pytest.raises(ValueError):
            w.add_array("bad", mat, codec="lz4")
    r = ArtifactReader(p, "t")
    assert (r.array("mask") == mask).all()
    assert (r.array("mat") == mat).all()
    assert os.path.getsize(os.path.join(p, "mask.npy.z")) < mask.nbytes // 50


def test_container_codec_family(tmp_path):
    """Every registered codec (zlib/bz2/lzma — the reference's
    zip/bzip/entropy-coder classes) round-trips bit-exactly."""
    import numpy as np

    from biograph_jax.core.container import ArtifactReader, ArtifactWriter

    rng = np.random.default_rng(7)
    data = {
        "runs": np.repeat(rng.integers(0, 4, 300), 37).astype(np.uint8),
        "floats": rng.normal(size=(64, 33)).astype(np.float32),
    }
    for codec in ("zlib", "bz2", "lzma"):
        p = str(tmp_path / f"{codec}.bgt")
        with ArtifactWriter(p, "t") as w:
            for k, v in data.items():
                w.add_array(k, v, codec=codec)
        r = ArtifactReader(p, "t")
        for k, v in data.items():
            got = r.array(k)
            assert got.dtype == v.dtype and (got == v).all(), (codec, k)
        # the compressible part actually compressed
        assert (
            os.path.getsize(os.path.join(p, "runs.npy.z"))
            < data["runs"].nbytes // 10
        ), codec
