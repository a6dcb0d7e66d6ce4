"""``repro_torch.ops.autotune`` on the CPU, mirroring the reference's
cache tests (``tests/test_frontier.py``: round trip, corrupt file,
missing entry, env overrides, smoke), plus: ``bucket_key`` is the
reference's, and a checkpoint's ``frontier_tuning`` that differs from
the current cache warns and never refuses, in either package, on the
other's checkpoint. The port has one candidate, the kernel's own table
sizing (1.5 slots an entry); the layering of defaults, cache and env is
checked with two more candidates patched in. Timing the candidates needs
the card (``chip_smoke.py``'s phase 2 and the CLI); here the tuner
refuses. Tolerance: exact (strings, integers, the cache's floats)."""
import json

import pytest
import torch

from repro.core import samplers as JS
from repro.ops import autotune as jtune
from repro.runtime import checkpoint as jck
from repro_torch.core import samplers as TS
from repro_torch.ops import autotune
from repro_torch.runtime import checkpoint as ck

torch.set_num_threads(1)


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.delenv(autotune.LOAD_ENV, raising=False)
    autotune.reload()
    yield path
    autotune.reload()


@pytest.fixture
def three_loads(monkeypatch):
    """Two more candidates than the port has, to see each layer win."""
    monkeypatch.setattr(autotune, "TABLE_LOADS", (1.5, 3.0, 6.0))


def test_missing_cache_falls_back_to_defaults(tune_cache):
    assert not tune_cache.exists()
    for prim, want in autotune.DEFAULT_PARAMS.items():
        assert autotune.get_params(prim, E=40960, S=512) == want
    assert autotune.cache_fingerprint() is None


def test_roundtrip(tune_cache, three_loads, monkeypatch):
    key = autotune.bucket_key("hash_dedup", "cuda", {"E": 40960, "S": 512})
    c = autotune.TuneCache.load(str(tune_cache))
    c.put(key, {"table_load": 3.0, "us": 42.0})
    c.save()
    autotune.reload()
    got = autotune.get_params("hash_dedup", E=40000, S=500)  # same bucket
    assert got == {"table_load": 3.0}                  # timing not a knob
    assert autotune.get_params("hash_dedup", E=1000, S=512) == \
        autotune.DEFAULT_PARAMS["hash_dedup"]          # another bucket
    assert autotune.cache_fingerprint() is not None
    # a load no candidate has degrades to the default
    c.put(key, {"table_load": 2.0})
    c.save()
    autotune.reload()
    assert autotune.get_params("hash_dedup", E=40960, S=512) == \
        autotune.DEFAULT_PARAMS["hash_dedup"]
    # the port's own candidates: a cached 3.0 is no candidate either
    monkeypatch.undo()
    assert autotune.TABLE_LOADS == (1.5,)
    c.put(key, {"table_load": 3.0, "us": 42.0})
    c.save()
    autotune.reload()
    assert autotune.get_params("hash_dedup", E=40960, S=512) == \
        autotune.DEFAULT_PARAMS["hash_dedup"]
    assert autotune.TuneCache.load(str(tune_cache)).get(key) == \
        {"table_load": 3.0, "us": 42.0}                # carried as written


def test_corrupt_file_degrades_to_defaults(tune_cache, capsys):
    tune_cache.write_text("{not json at all")
    autotune.reload()
    assert autotune.get_params("hash_dedup", E=512, S=64) == \
        autotune.DEFAULT_PARAMS["hash_dedup"]
    assert "ignoring unusable tuning cache" in capsys.readouterr().err
    tune_cache.write_text('{"version": 999, "entries": []}')
    autotune.reload()
    assert autotune.get_params("hash_dedup", E=512, S=64) == \
        autotune.DEFAULT_PARAMS["hash_dedup"]


def test_env_override_beats_cache(tune_cache, three_loads, monkeypatch):
    key = autotune.bucket_key("hash_dedup", "cuda", {"E": 512, "S": 64})
    c = autotune.TuneCache.load(str(tune_cache))
    c.put(key, {"table_load": 3.0})
    c.save()
    autotune.reload()
    monkeypatch.setenv(autotune.LOAD_ENV, "6")
    assert autotune.get_params("hash_dedup", E=512, S=64) == \
        {"table_load": 6.0}
    monkeypatch.setenv(autotune.LOAD_ENV, "not a number")
    assert autotune.get_params("hash_dedup", E=512, S=64) == \
        {"table_load": 3.0}


def test_smoke_needs_the_card_and_its_format_reads_back(tune_cache):
    """The tuner times on the card only; a cache in the format it writes
    (the reference's: version 1, entries with the winner and its us)
    reads back through dispatch."""
    with pytest.raises(RuntimeError, match="no card"):
        autotune.main(["--smoke", "--cache", str(tune_cache)])
    assert [c["table_load"] for c in autotune.candidates("hash_dedup")] == \
        [1.5]
    doc = {"version": 1, "entries": {
        autotune.bucket_key("hash_dedup", "cuda", {"E": 1_128_448,
                                                   "S": 22_272}):
            {"table_load": 1.5, "us": 88.5}}}
    tune_cache.write_text(json.dumps(doc))
    autotune.reload()
    assert autotune.get_params("hash_dedup", E=1_128_448, S=22_272) == \
        {"table_load": 1.5}
    assert autotune.cache_fingerprint() == \
        jtune.TuneCache(str(tune_cache), doc["entries"]).fingerprint()


def test_bucket_key_is_the_reference_s():
    for shapes in ({"E": 1}, {"E": 7000, "S": 8191}, {"S": 0, "E": 2**20},
                   {"E": 9_426_304, "S": 470_656}):
        for prim in ("hash_dedup", "compact"):
            assert autotune.bucket_key(prim, "cuda", shapes) == \
                jtune.bucket_key(prim, "cuda", shapes)
        for n in shapes.values():
            assert autotune._bucket(n) == jtune._bucket(n)


def _samplers():
    kw = dict(batch_size=64, fanouts=(4, 4), avg_degree=10.0,
              max_degree=100, num_vertices=1000, num_edges=10_000)
    return TS.from_graph_stats("labor-0", **kw), \
        JS.from_graph_stats("labor-0", **kw)


def test_checkpoints_of_either_package_restore_with_a_warning(tune_cache):
    ts, js = _samplers()
    meta = json.loads(json.dumps(ck.engine_restore_meta(ts,
                                                        backend="eager")))
    assert meta["frontier_tuning"] is None            # no cache: defaults
    other = {**meta, "frontier_tuning": "0123456789ab"}
    with pytest.warns(UserWarning, match="frontier tuning cache differs"):
        back = ck.validate_restore_meta(other, ts, backend="eager")
    assert back.caps == ts.caps
    with pytest.warns(UserWarning, match="frontier tuning cache differs"):
        jck.validate_restore_meta(other, js)          # the port's, in repro
    jmeta = json.loads(json.dumps(jck.engine_restore_meta(js)))
    with pytest.warns(UserWarning, match="frontier tuning cache differs"):
        ck.validate_restore_meta({**jmeta, "frontier_tuning": "feed"}, ts)
