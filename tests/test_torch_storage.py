"""The port's persistent store is a copy of the JAX package's, with the
same on-disk format: a log (or npz directory) written by
``repro.storage`` reopens and reads back identically in
``repro_torch.storage``, tombstones, fills and compaction included, and
the reverse. Comparisons are exact: the bytes are the same."""
import numpy as np
import pytest

from repro import storage as jstorage
from repro_torch import storage as tstorage

W1, W2 = (0.0, 10.0), (10.0, 20.0)


def _arrays(fill, cap=64, width=3, seed=0):
    rng = np.random.default_rng(seed)
    a = {"keys": np.zeros((cap,), np.int32),
         "timestamps": np.zeros((cap,), np.float64),
         "values": np.zeros((cap, width), np.float32)}
    a["keys"][:fill] = rng.integers(0, 99, fill)
    a["timestamps"][:fill] = rng.uniform(0.0, 100.0, fill)
    a["values"][:fill] = rng.normal(size=(fill, width))
    return a


def _write(pkg, path, backend):
    """Blocks across two windows, a rewrite at a larger fill, and a
    tombstone; returns the expected live contents."""
    s = pkg.make_store(backend, path, segment_bytes=4096)
    want = {}
    for bid, (w, fill) in enumerate([(W1, 17), (W1, 64), (W2, 5),
                                     (W2, 40), (W1, 9)], start=1):
        a = _arrays(fill, seed=bid)
        s.put(w, bid, a, fill)
        want[(w, bid)] = (a, fill)
    s.commit()
    a = _arrays(30, seed=99)
    s.put(W2, 3, a, 30)                         # append-only rewrite
    want[(W2, 3)] = (a, 30)
    s.delete(W1, 5)
    del want[(W1, 5)]
    s.commit()
    s.close()
    return want


def _check(pkg, path, backend, want):
    s = pkg.make_store(backend, path, segment_bytes=4096)
    assert s.get(W1, 5) is None                 # tombstone survived
    for (w, bid), (a, fill) in want.items():
        if backend == "log":
            # the npz layout is the bare arrays: no fill across a reopen
            assert s.current_fill(w, bid) == fill
        got = s.get(w, bid)
        for k in ("keys", "timestamps", "values"):
            np.testing.assert_array_equal(got[k][:fill], a[k][:fill])
            assert got[k].shape == a[k].shape
    if backend == "log":
        assert sorted(s.keys()) == sorted(want)
        s.compact_if_needed(1.0)
        s.close()
        s = pkg.make_store(backend, path, segment_bytes=4096)
        for (w, bid), (a, fill) in want.items():
            np.testing.assert_array_equal(s.get(w, bid)["values"][:fill],
                                          a["values"][:fill])
    s.close()


@pytest.mark.parametrize("backend", ["log", "npz"])
def test_jax_written_store_reopens_in_port(tmp_path, backend):
    want = _write(jstorage, tmp_path, backend)
    _check(tstorage, tmp_path, backend, want)


@pytest.mark.parametrize("backend", ["log", "npz"])
def test_port_written_store_reopens_in_jax(tmp_path, backend):
    want = _write(tstorage, tmp_path, backend)
    _check(jstorage, tmp_path, backend, want)


def test_torn_tail_recovery_matches(tmp_path):
    """A log whose unacknowledged tail was torn recovers to the same
    acknowledged records in both packages."""
    want = _write(jstorage, tmp_path / "a", "log")
    segs = sorted((tmp_path / "a").glob("*"))
    last = max((p for p in segs if p.is_file()), key=lambda p: p.name)
    with open(last, "ab") as f:
        f.write(b"\x00garbage-tail" * 7)
    import shutil
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    _check(tstorage, tmp_path / "a", "log", want)
    _check(jstorage, tmp_path / "b", "log", want)
