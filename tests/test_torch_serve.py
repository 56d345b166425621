"""The port's serving path (``TieredKVCache``, ``ContinuousBatcher``,
``tiered_kv_cache_from_jax``) against the JAX package's, replaying the five
serve tests of ``tests/test_fault_serve.py`` on both packages with the
same seeds, plus a thrash case and a carry-over of a JAX cache mid-run.

Both caches run the same policy code, so their bookkeeping must be
identical: tables, lengths, missing pages, stats, owners and free lists,
step by step; pool contents bit for bit, bfloat16 included, after pages
go to the host and come back. The port's step runs the plain version of
K4 here (CPU tensors); the JAX step runs its Pallas kernel in interpret
mode. Outputs agree within rtol and atol 1e-5 (float32; both compute in
fp32 and sum in another order) where the launched table has no -1 page
inside a sequence. Where it has one (the JAX victim policy can evict a
page of the batch being launched, ROADMAP Queue 3), the Pallas wrapper
reads the page as page 0, and the port follows the JAX ``ref`` oracle
instead: those rows are held against ``ref`` on the JAX cache's own
table and pool. bfloat16 outputs agree within 2e-2 (each side rounds an
fp32 result to bf16 once).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.serve.scheduler as j_sched_mod
from repro.core.cleanup import PredictiveCleanup as JCleanup
from repro.kernels import ref as JR
from repro.serve.kvcache import TieredKVCache as JCache
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch.convert import tiered_kv_cache_from_jax
from repro_torch.core.cleanup import PredictiveCleanup as TCleanup
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as TR
from repro_torch.serve import ContinuousBatcher, Request, TieredKVCache

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _caches(pages=8, page=16, hkv=2, d=32, layers=1, dtype="float32"):
    kw = dict(num_device_pages=pages, page_size=page, num_kv_heads=hkv,
              head_dim=d, num_layers=layers)
    j = JCache(**kw, dtype=JDT[dtype],
               cleanup=JCleanup(min_history=10**9, initial_bound=1e9))
    t = TieredKVCache(**kw, dtype=TDT[dtype], device="cpu",
                      cleanup=TCleanup(min_history=10**9, initial_bound=1e9))
    return j, t


def _bits(x):
    """A pool or host page as comparable integer bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 \
            else x.view(torch.int32)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


def _same_books(j, t):
    assert list(j.sessions) == list(t.sessions)
    for sid, js in j.sessions.items():
        ts = t.sessions[sid]
        assert (js.length, js.pages, js.last_arrival, js.gap_ewma,
                js.finished) == (ts.length, ts.pages, ts.last_arrival,
                                 ts.gap_ewma, ts.finished), sid
        assert list(js.host_pages) == list(ts.host_pages), sid
        for li, (jk, jv) in js.host_pages.items():
            tk, tv = ts.host_pages[li]
            assert np.array_equal(_bits(jk), _bits(tk))
            assert np.array_equal(_bits(jv), _bits(tv))
    assert j.owner == t.owner
    assert j.free_pages == t.free_pages
    assert j.stats == t.stats


def _same_pools(j, t):
    assert np.array_equal(_bits(j.k_pool), _bits(t.k_pool))
    assert np.array_equal(_bits(j.v_pool), _bits(t.v_pool))


def _same_table(j, t, sids, pps):
    jt, jl, jm = j.block_table(sids, pages_per_seq=pps)
    tt, tl, tm = t.block_table(sids, pages_per_seq=pps)
    assert tt.dtype == torch.int32 and tl.dtype == torch.int32
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert jm == tm
    return tt, tl, tm


# ------------------------------------------------------ the five serve tests
def test_kvcache_append_and_table():
    j, t = _caches()
    j.open_session(1, now=0.0)
    t.open_session(1, now=0.0)
    rng = np.random.default_rng(0)
    for step in range(40):
        k, v = rng.normal(size=(1, 2, 32)), rng.normal(size=(1, 2, 32))
        assert j.append_token_kv(1, k, v, now=float(step))
        assert t.append_token_kv(1, k, v, now=float(step))
    table, lens, missing = _same_table(j, t, [1], 4)
    assert int(lens[0]) == 40
    assert int((table[0] >= 0).sum()) == 3          # ceil(40/16)
    assert not missing
    _same_books(j, t)
    _same_pools(j, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kvcache_offload_and_restage_preserves_contents(dtype):
    """Fill beyond the device pool; evicted pages restage losslessly, bit
    for bit, in both packages."""
    rng = np.random.default_rng(1)
    caches = _caches(pages=4, page=8, dtype=dtype)
    for c in caches:
        c.open_session(1, now=0.0)
        c.open_session(2, now=0.0)
        c.sessions[2].gap_ewma = 1e6     # session 2 predicted idle
        c.sessions[1].gap_ewma = 0.01
    for step in range(24):
        k = rng.normal(size=(1, 2, 32)).astype(np.float32)
        v = rng.normal(size=(1, 2, 32)).astype(np.float32)
        sid = 1 if step % 2 == 0 else 2
        for c in caches:
            assert c.append_token_kv(sid, k, v, now=float(step))
    _same_books(*caches)
    before = [np.array(_bits(c.k_pool)) for c in caches]
    for c in caches:                     # all of session 2 out, then back
        for li, pg in enumerate(list(c.sessions[2].pages)):
            if pg >= 0:
                c._destage_page(2, li)
        assert all(p < 0 for p in c.sessions[2].pages)
    _same_books(*caches)
    for c in caches:
        for li in list(c.sessions[2].host_pages):
            assert c._stage_page(2, li, now=100.0)
        assert all(p >= 0 for p in c.sessions[2].pages)
        assert c.stats["destaged"] >= 1 and c.stats["staged"] >= 1
    _same_books(*caches)
    _same_pools(*caches)
    j, t = caches
    assert np.array_equal(before[0], before[1])


def test_kvcache_tiered_attention_matches_reference():
    rng = np.random.default_rng(2)
    pages, page, hkv, d = 6, 8, 2, 32
    j, t = _caches(pages=pages, page=page, hkv=hkv, d=d)
    for c in (j, t):
        c.open_session(1, now=0.0)
    n_tok = 30
    k_all = rng.normal(size=(n_tok, 1, hkv, d)).astype(np.float32)
    v_all = rng.normal(size=(n_tok, 1, hkv, d)).astype(np.float32)
    for step in range(n_tok):
        for c in (j, t):
            c.append_token_kv(1, k_all[step], v_all[step], now=float(step))
    for c in (j, t):                     # page 1 out: the table reports it
        c._destage_page(1, 1)
    _, _, missing = _same_table(j, t, [1], 4)
    assert missing == [(1, 1)]
    for c in (j, t):
        assert c._stage_page(1, 1, now=50.0)
    table, lens, _ = _same_table(j, t, [1], 4)
    _same_books(j, t)

    q = rng.normal(size=(1, 4, d)).astype(np.float32)
    out = TR.ref_decode_attention_paged(torch.from_numpy(q), t.k_pool[0],
                                        t.v_pool[0], table, lens)
    jout = JR.ref_decode_attention_paged(
        jnp.asarray(q), j.k_pool[0], j.v_pool[0], *j.block_table([1], 4)[:2])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    # reference over the raw (untiered) kv
    pad = 4 * page - n_tok
    kp = np.pad(k_all[:, 0], ((0, pad), (0, 0), (0, 0))) \
        .reshape(4, page, hkv, d)
    vp = np.pad(v_all[:, 0], ((0, pad), (0, 0), (0, 0))) \
        .reshape(4, page, hkv, d)
    ref = TR.ref_decode_attention_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.arange(4, dtype=torch.int32)[None],
        torch.tensor([n_tok], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_kvcache_predictive_cleanup_evicts_idle_sessions():
    j, t = _caches()
    j.cleanup = JCleanup(coverage=0.9, confidence=0.9, min_history=10,
                         initial_bound=1e9)
    t.cleanup = TCleanup(coverage=0.9, confidence=0.9, min_history=10,
                         initial_bound=1e9)
    rng = np.random.default_rng(3)
    for c in (j, t):
        c.open_session(1, now=0.0)
        c.open_session(2, now=0.0)
    for step in range(8):
        k, v = rng.normal(size=(1, 2, 32)), rng.normal(size=(1, 2, 32))
        for c in (j, t):
            c.append_token_kv(1, k, v, now=0.1 * step)
            c.observe_arrival(1, now=0.1 * step)
    gaps = rng.uniform(0.05, 0.2, 1000)          # short gaps typical
    for c in (j, t):
        c.cleanup.observe(gaps)
    assert t.cleanup.current_bound() == j.cleanup.current_bound() < 1.0
    _same_books(j, t)
    assert j.cleanup_idle(now=100.0) == t.cleanup_idle(now=100.0) == 2
    assert not t.sessions
    _same_books(j, t)


class _Feed:
    """Per-step query and new-token K/V, the same numbers for both
    packages: step ``n`` draws from ``default_rng(seed + n)``."""

    def __init__(self, seed, h, layers, hkv, d, dtype, torch_side):
        self.seed, self.n = seed, 0
        self.shape = (h, layers, hkv, d)
        self.dtype, self.torch_side = dtype, torch_side

    def q_fn(self, sids):
        h, _, _, d = self.shape
        rng = np.random.default_rng(self.seed + self.n)
        q = rng.normal(size=(len(sids), h, d)).astype(np.float32)
        if self.torch_side:
            return torch.from_numpy(q).to(TDT[self.dtype])
        return jnp.asarray(q, JDT[self.dtype])

    def kv_fn(self, sids):
        _, layers, hkv, d = self.shape
        rng = np.random.default_rng(10_000 + self.seed + self.n)
        self.n += 1
        return (rng.normal(size=(len(sids), layers, hkv, d))
                .astype(np.float32),
                rng.normal(size=(len(sids), layers, hkv, d))
                .astype(np.float32))


@pytest.fixture
def launches(monkeypatch):
    """Record every K4 launch of both schedulers: the JAX one's table,
    lengths, query and layer-0 pools (immutable), and the port's output."""
    rec = {"jax": [], "torch": []}
    j_fn = j_sched_mod.decode_attention_paged
    t_fn = t_ops.decode_attention_paged

    def j_rec(q, kp, vp, table, lens):
        out = j_fn(q, kp, vp, table, lens)
        rec["jax"].append(dict(q=q, kp=kp, vp=vp, table=np.asarray(table),
                               lens=np.asarray(lens), out=np.asarray(out)))
        return out

    def t_rec(q, kp, vp, table, lens, **kw):
        out = t_fn(q, kp, vp, table, lens, **kw)
        rec["torch"].append(dict(table=table.numpy().copy(),
                                 lens=lens.numpy().copy(), out=out))
        return out

    monkeypatch.setattr(j_sched_mod, "decode_attention_paged", j_rec)
    monkeypatch.setattr(t_ops, "decode_attention_paged", t_rec)
    return rec


def _minus_one_rows(table, lens, page):
    """Rows whose table has a -1 page inside the sequence."""
    need = -(-lens // page)
    cols = np.arange(table.shape[1])[None, :]
    return np.nonzero(((table < 0) & (cols < need[:, None])).any(1))[0]


def _check_launches(rec, page, dtype):
    """Same tables and lengths at every launch; outputs against JAX
    (Pallas) where no -1 page lies inside a sequence, else against JAX
    ``ref`` on the JAX cache's own table and pool. Returns the count of
    rows that had such a page."""
    assert len(rec["jax"]) == len(rec["torch"]) > 0
    tol = OUT_TOL[dtype]
    bad_rows = 0
    for jl, tl in zip(rec["jax"], rec["torch"]):
        assert np.array_equal(jl["table"], tl["table"])
        assert np.array_equal(jl["lens"], tl["lens"])
        out = tl["out"].float().numpy()
        want = np.asarray(jl["out"], np.float32).copy()
        rows = _minus_one_rows(jl["table"], jl["lens"], page)
        if rows.size:
            bad_rows += rows.size
            ref = np.asarray(JR.ref_decode_attention_paged(
                jl["q"], jl["kp"], jl["vp"], jnp.asarray(jl["table"]),
                jnp.asarray(jl["lens"])), np.float32)
            want[rows] = ref[rows]
        np.testing.assert_allclose(out, want, rtol=tol, atol=tol)
    return bad_rows


def _batchers(caches, **kw):
    j, t = caches
    return JBatcher(j, **kw), ContinuousBatcher(t, **kw)


def _submit(batchers, rng, n_req, prompt, max_new, layers, hkv, d):
    for rid in range(n_req):
        plen = int(prompt) if np.isscalar(prompt) else \
            int(rng.integers(*prompt))
        kp = rng.normal(size=(layers, plen, hkv, d)).astype(np.float32)
        vp = rng.normal(size=(layers, plen, hkv, d)).astype(np.float32)
        for b, req_cls in zip(batchers, (JRequest, Request)):
            b.submit(req_cls(request_id=rid, session_id=rid, prompt_len=plen,
                             max_new_tokens=max_new, arrived_at=0.0),
                     kp, vp, now=0.0)


def _run(batchers, feeds, steps, pps, t0=1.0, dt=0.1, until=None):
    j, t = batchers
    now = t0
    for _ in range(steps):
        jo = j.step(feeds[0].q_fn, feeds[0].kv_fn, now=now)
        to = t.step(feeds[1].q_fn, feeds[1].kv_fn, now=now)
        assert (jo is None) == (to is None)
        _same_books(j.cache, t.cache)
        assert [r.session_id for r in j.active] == \
            [r.session_id for r in t.active]
        now += dt
        if until is not None and len(t.completed) == until:
            break
    return now


def test_continuous_batcher_completes_requests(launches):
    rng = np.random.default_rng(4)
    hkv, d, page = 2, 32, 8
    caches = _caches(pages=16, page=page, hkv=hkv, d=d)
    batchers = _batchers(caches, max_batch=2, pages_per_seq=8)
    _submit(batchers, rng, 3, 5, 4, 1, hkv, d)
    feeds = [_Feed(40, 4, 1, hkv, d, "float32", side) for side in (0, 1)]
    _run(batchers, feeds, 20, 8, until=3)
    j, t = batchers
    assert len(t.completed) == len(j.completed) == 3
    assert all(r.generated == 4 for r in t.completed)
    assert [(r.request_id, r.first_token_at, r.finished_at)
            for r in t.completed] == \
        [(r.request_id, r.first_token_at, r.finished_at)
         for r in j.completed]
    _check_launches(launches, page, "float32")
    _same_pools(*caches)


# -------------------------------------------------------------- thrashing
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_thrash_moves_the_same_pages(launches, dtype):
    """A device pool below the live pages: both packages stage and
    destage the same pages at every step, and the victim policy evicts
    pages of the batch being launched (-1 pages inside ``seq_len``)."""
    rng = np.random.default_rng(5)
    hkv, d, page, layers = 2, 32, 8, 2
    caches = _caches(pages=14, page=page, hkv=hkv, d=d, layers=layers,
                     dtype=dtype)
    batchers = _batchers(caches, max_batch=3, pages_per_seq=12)
    _submit(batchers, rng, 6, (20, 60), 6, layers, hkv, d)
    _same_books(*caches)
    feeds = [_Feed(50, 4, layers, hkv, d, dtype, side) for side in (0, 1)]
    _run(batchers, feeds, 40, 12, dt=0.05, until=6)
    j, t = batchers
    assert len(t.completed) == len(j.completed) == 6
    assert t.cache.stats["staged"] > 0 and t.cache.stats["destaged"] > 0
    assert _check_launches(launches, page, dtype) > 0
    _same_pools(*caches)


# -------------------------------------------------- carrying a JAX cache over
def _jax_state(c):
    """A JAX cache's state as plain Python and numpy."""
    cl = c.cleanup
    return {
        "k_pool": np.asarray(c.k_pool), "v_pool": np.asarray(c.v_pool),
        "sessions": {
            sid: {"length": s.length, "pages": list(s.pages),
                  "host_pages": {li: (np.asarray(k), np.asarray(v))
                                 for li, (k, v) in s.host_pages.items()},
                  "last_arrival": s.last_arrival, "gap_ewma": s.gap_ewma,
                  "finished": s.finished}
            for sid, s in c.sessions.items()},
        "owner": dict(c.owner), "free_pages": list(c.free_pages),
        "stats": dict(c.stats),
        "cleanup": {"coverage": cl.coverage, "confidence": cl.confidence,
                    "initial_bound": cl.initial_bound,
                    "min_history": cl.min_history, "bound": cl._bound,
                    "hist_counts": np.asarray(cl.hist.counts),
                    "hist_total": cl.hist.total}}


def _port_request(r):
    return Request(**{k: getattr(r, k) for k in (
        "request_id", "session_id", "prompt_len", "max_new_tokens",
        "arrived_at", "generated", "done", "first_token_at",
        "finished_at")})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiered_kv_cache_from_jax_continues_identically(launches, dtype):
    """A JAX cache mid-run (pages on the host, pages thrashing) carried
    into the port: both continue to identical bookkeeping, pool bits and
    outputs."""
    rng = np.random.default_rng(6)
    hkv, d, page, layers = 2, 32, 8, 2
    j = _caches(pages=14, page=page, hkv=hkv, d=d, layers=layers,
                dtype=dtype)[0]
    jb = JBatcher(j, max_batch=3, pages_per_seq=12)
    for rid in range(6):
        plen = int(rng.integers(20, 60))
        jb.submit(JRequest(request_id=rid, session_id=rid, prompt_len=plen,
                           max_new_tokens=8, arrived_at=0.0),
                  rng.normal(size=(layers, plen, hkv, d)).astype(np.float32),
                  rng.normal(size=(layers, plen, hkv, d)).astype(np.float32),
                  now=0.0)
    jfeed = _Feed(60, 4, layers, hkv, d, dtype, False)
    now = 1.0
    for _ in range(5):
        jb.step(jfeed.q_fn, jfeed.kv_fn, now=now)
        now += 0.05
    assert any(s.host_pages for s in j.sessions.values())

    t = tiered_kv_cache_from_jax(_jax_state(j), device="cpu")
    assert t.k_pool.dtype == TDT[dtype]
    _same_books(j, t)
    _same_pools(j, t)
    tb = ContinuousBatcher(t, max_batch=3, pages_per_seq=12)
    tb.waiting.extend(_port_request(r) for r in jb.waiting)
    tb.active = [_port_request(r) for r in jb.active]
    tb.completed = [_port_request(r) for r in jb.completed]
    tb.steps = jb.steps
    launches["jax"].clear()
    tfeed = _Feed(60, 4, layers, hkv, d, dtype, True)
    tfeed.n = jfeed.n
    _run((jb, tb), (jfeed, tfeed), 40, 12, t0=now, dt=0.05, until=6)
    assert len(tb.completed) == len(jb.completed) == 6
    _check_launches(launches, page, dtype)
    _same_pools(j, t)


def test_tiered_kv_cache_from_jax_validates():
    j = _caches(pages=4, page=8)[0]
    j.open_session(1, now=0.0)
    for step in range(10):
        j.append_token_kv(1, np.ones((1, 2, 32)), np.ones((1, 2, 32)),
                          now=float(step))
    good = _jax_state(j)
    tiered_kv_cache_from_jax(good, device="cpu")
    bad = _jax_state(j)
    bad["free_pages"] = bad["free_pages"] + [j.sessions[1].pages[0]]
    with pytest.raises(ValueError, match="free_pages"):
        tiered_kv_cache_from_jax(bad, device="cpu")
    bad = _jax_state(j)
    bad["owner"] = {pg: (2, li) for pg, (_, li) in bad["owner"].items()}
    with pytest.raises(ValueError, match="owned by"):
        tiered_kv_cache_from_jax(bad, device="cpu")
    bad = _jax_state(j)
    bad["sessions"][1]["host_pages"] = {0: (np.zeros((1, 8, 2, 32)),) * 2}
    with pytest.raises(ValueError, match="host page"):
        tiered_kv_cache_from_jax(bad, device="cpu")


def test_cache_defaults_to_the_card():
    """The cache's pools go to the card unless the caller asks for the
    CPU; where CUDA is missing that raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TieredKVCache(num_device_pages=2, page_size=4, num_kv_heads=1,
                          head_dim=32, num_layers=1)
    c = TieredKVCache(num_device_pages=2, page_size=4, num_kv_heads=1,
                      head_dim=32, num_layers=1, device="cpu")
    assert c.k_pool.dtype == torch.bfloat16 and c.k_pool.shape == \
        (1, 2, 4, 1, 32)
