"""The record cache (``-c``, fwumious_wabbit_tpu_torch/ingest/cache.py)
against the JAX package's: the writer's files byte-equal to JAX's for both
codecs and each package reading the other's; with ``zstandard`` made
unimportable, a raw cache written and a zstd one refused as stale and
rebuilt; the CLI with ``-c`` twice (``--fwt_pack_cache off``, so the
second run reads the record cache) on both ingest paths, byte-identical
predictions and model files, equal to the JAX CLI's (-p within 2e-6), the
cache byte-equal to the one the JAX CLI writes; ``-c`` with the pack
cache's ``auto``; a truncated cache; and ``--build_cache_without_training``
with JAX's cache bytes."""

import logging
import sys

import numpy as np
import pytest

from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap as JaxVw
from fwumious_wabbit_tpu.ingest import cache as jcache
from fwumious_wabbit_tpu.train.loop import main as jax_main
from fwumious_wabbit_tpu_torch.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu_torch.ingest import cache
from fwumious_wabbit_tpu_torch.train.loop import main

from test_torch_train_cli import MODEL_ARGV, data_file
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import VW_CSV, jax_native_loaded  # noqa: F401 (autouse fixture)


@pytest.fixture
def no_zstandard(monkeypatch):
    """``import zstandard`` fails from here on, as on a host without it."""
    monkeypatch.setitem(sys.modules, "zstandard", None)


def records(n=300, seed=0):
    """u32 records of the cache's framing: the first word is the record's
    length in words."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.integers(0, 1 << 32, rng.integers(2, 40), dtype=np.uint64).astype(np.uint32)
        r[0] = len(r)
        out.append(r)
    return out


def write(module, vw, path, recs, compress):
    w = module.RecordCacheWriter(path, vw, compress=compress)
    for r in recs:
        w.push_record(r)
    w.write_finish()
    return path.read_bytes()


@pytest.mark.parametrize("compress", [True, False], ids=["zstd", "raw"])
def test_writer_and_reader_match_jax(tmp_path, compress):
    recs = records()
    jbytes = write(jcache, JaxVw.from_string(VW_CSV), tmp_path / "j.fwcache",
                   recs, compress)
    pbytes = write(cache, VwNamespaceMap.from_string(VW_CSV), tmp_path / "p.fwcache",
                   recs, compress)
    assert pbytes == jbytes
    codec = int.from_bytes(pbytes[8:12], "little")
    assert codec == (cache.CODEC_ZSTD if compress else cache.CODEC_RAW)
    got = list(cache.RecordCacheReader(tmp_path / "j.fwcache",
                                       VwNamespaceMap.from_string(VW_CSV)))
    want = list(jcache.RecordCacheReader(tmp_path / "p.fwcache", JaxVw.from_string(VW_CSV)))
    assert len(got) == len(want) == len(recs)
    for a, b, r in zip(got, want, recs):
        assert a.tobytes() == b.tobytes() == r.tobytes()
    assert not (tmp_path / "p.fwcache.writing").exists()


def test_without_zstandard_writes_raw_and_refuses_zstd(tmp_path, no_zstandard):
    vw = VwNamespaceMap.from_string(VW_CSV)
    recs = records(50)
    raw = write(cache, vw, tmp_path / "p.fwcache", recs, None)
    assert int.from_bytes(raw[8:12], "little") == cache.CODEC_RAW
    assert raw == write(jcache, JaxVw.from_string(VW_CSV), tmp_path / "j.fwcache",
                        recs, False)
    assert [r.tobytes() for r in cache.RecordCacheReader(tmp_path / "p.fwcache", vw)] \
        == [r.tobytes() for r in recs]
    write(jcache, JaxVw.from_string(VW_CSV), tmp_path / "z.fwcache", recs, True)
    with pytest.raises(cache.StaleCacheError, match="zstd"):
        cache.RecordCacheReader(tmp_path / "z.fwcache", vw)
    with pytest.raises(RuntimeError, match="zstandard"):
        cache.RecordCacheWriter(tmp_path / "x.fwcache", vw, compress=True)


def read(path):
    return np.array([float(x) for x in path.read_text().split()])


def cli_args(tmp_path, extra=()):
    data = data_file(tmp_path, n=150)
    return MODEL_ARGV + ["--data", str(data), "--fwt_batch_size", "16", "-c",
                         "--fwt_pack_cache", "off", *extra]


@pytest.mark.parametrize("path", [[], ["--fwt_no_native"]], ids=["native", "python"])
def test_cli_records_then_reads_the_cache(tmp_path, caplog, path):
    argv = cli_args(tmp_path, path)
    fwcache = tmp_path / "d.vw.fwcache"
    assert jax_main(argv + ["-p", str(tmp_path / "j.out")]) == 0
    jax_file = fwcache.read_bytes()
    fwcache.unlink()
    outs = []
    for run in ("record", "read"):
        p, f = tmp_path / f"{run}.out", tmp_path / f"{run}.fwt"
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(argv + ["-p", str(p), "-f", str(f), "--save_resume",
                                "--fwt_platform", "cpu"]) == 0
        used = any("using cache file" in r.message for r in caplog.records)
        assert used == (run == "read")
        assert fwcache.read_bytes() == jax_file
        outs.append((p.read_bytes(), f.read_bytes()))
    assert outs[0] == outs[1]
    np.testing.assert_allclose(read(tmp_path / "read.out"), read(tmp_path / "j.out"),
                               rtol=0, atol=2e-6)


def test_cli_rebuilds_a_zstd_cache_without_zstandard(tmp_path, caplog, monkeypatch):
    """A zstd cache (the JAX CLI's) on a host without zstandard: the port
    warns, naming the codec, retrains from the text and leaves a raw
    cache, whose read gives the same predictions."""
    argv = cli_args(tmp_path)
    fwcache = tmp_path / "d.vw.fwcache"
    assert jax_main(argv + ["-p", str(tmp_path / "j.out")]) == 0
    assert int.from_bytes(fwcache.read_bytes()[8:12], "little") == cache.CODEC_ZSTD
    monkeypatch.setitem(sys.modules, "zstandard", None)
    outs = []
    for run in ("rebuild", "read"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(argv + ["-p", str(tmp_path / f"{run}.out"),
                                "--fwt_platform", "cpu"]) == 0
        messages = [r.message for r in caplog.records]
        if run == "rebuild":
            assert any("cache rejected" in m and "zstd" in m for m in messages)
        else:
            assert any("using cache file" in m and "(raw)" in m for m in messages)
        assert int.from_bytes(fwcache.read_bytes()[8:12], "little") == cache.CODEC_RAW
        outs.append((tmp_path / f"{run}.out").read_bytes())
    assert outs[0] == outs[1]
    np.testing.assert_allclose(read(tmp_path / "read.out"), read(tmp_path / "j.out"),
                               rtol=0, atol=2e-6)


def test_cache_with_pack_cache_auto(tmp_path, caplog):
    """-c with --fwt_pack_cache auto: the first run records both caches,
    the second replays the pack cache (its stream comes first), with the
    same predictions."""
    argv = [a for a in cli_args(tmp_path) if a not in ("--fwt_pack_cache", "off")]
    outs = []
    for run in ("first", "second"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(argv + ["-p", str(tmp_path / f"{run}.out"),
                                "--fwt_platform", "cpu"]) == 0
        replayed = any("using pack cache" in r.message for r in caplog.records)
        assert replayed == (run == "second")
        assert (tmp_path / "d.vw.fwcache").is_file()
        assert (tmp_path / "d.vw.fwpack").is_file()
        outs.append((tmp_path / f"{run}.out").read_bytes())
    assert outs[0] == outs[1]


def test_truncated_cache_fails_the_run(tmp_path):
    """A cache that ends inside a record is never read as if whole: the
    default path raises, and the cache file is left as it was."""
    argv = cli_args(tmp_path) + ["--fwt_platform", "cpu"]
    assert main(argv) == 0
    fwcache = tmp_path / "d.vw.fwcache"
    # rewrite the same records raw, one word short
    vw = VwNamespaceMap.from_dataset_dir(str(tmp_path / "d.vw"))
    body = b"".join(r.tobytes() for r in cache.RecordCacheReader(fwcache, vw))
    w = cache.RecordCacheWriter(fwcache, vw, compress=False)
    w._writer.write(body[:-4])
    w.write_finish()
    short = fwcache.read_bytes()
    with pytest.raises(ValueError, match="truncated cache file"):
        main(argv)
    assert fwcache.read_bytes() == short


def test_build_cache_without_training_matches_jax(tmp_path):
    data = data_file(tmp_path, n=150)
    argv = MODEL_ARGV + ["--data", str(data), "-c", "--build_cache_without_training"]
    fwcache = tmp_path / "d.vw.fwcache"
    assert jax_main(argv) == 0
    want = fwcache.read_bytes()
    fwcache.unlink()
    # no card and no --fwt_platform: building the cache needs no device
    assert main(argv) == 0
    assert fwcache.read_bytes() == want
    assert not (tmp_path / "d.vw.fwcache.writing").exists()
    # and a training run reads it
    train = MODEL_ARGV + ["--data", str(data), "-c", "--fwt_pack_cache", "off",
                          "--fwt_platform", "cpu", "-p", str(tmp_path / "p.out")]
    assert main(train) == 0
    assert read(tmp_path / "p.out").shape == (150,)
    # the default path's recording run (records from the C++ ingest) writes
    # the same file as the Python parser's records here
    fwcache.unlink()
    assert main(train) == 0
    assert fwcache.read_bytes() == want
