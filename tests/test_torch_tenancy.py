"""The port's ``MultiTenantEngine`` against the JAX package's: the
counterparts of ``tests/test_tenancy.py``'s seven cases on the port (both
``pipelined`` parametrisations), each tenant's results against its own
standalone port engine and against the JAX ``MultiTenantEngine`` on the
same streams, ``from_profiles`` on the port with a Linear Road profile
(which the JAX package's ``from_profiles`` refuses), and the CPU
rehearsal of ``chip_smoke.py`` phase 14.

Everything runs on the CPU (``device="cpu"``). Tolerance: window means
within 1e-4 absolute, ``test_tenancy.py``'s.
"""
import numpy as np
import pytest

import repro.configs.base as jcfg
import repro.configs.workloads as jwl
import repro.core as jcore
import repro.core.batch_exec as jbx
import repro_torch.configs.base as tcfg
import repro_torch.configs.workloads as twl
import repro_torch.core as tcore
import repro_torch.core.batch_exec as tbx
from repro_torch.core.buckets import MemoryBudget, TenantBudget
import torch

PKGS = {"jax": (jcfg, jcore, jbx, jwl), "torch": (tcfg, tcore, tbx, twl)}
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def _stream(tenant_seed, n, width, lo, hi, pkg="torch"):
    rng = np.random.default_rng(tenant_seed)
    return PKGS[pkg][1].EventBatch(
        rng.integers(0, 8, n), rng.uniform(lo, hi, n),
        rng.normal(size=(n, width)).astype(np.float32))


def _specs(aion, pkg="torch"):
    core = PKGS[pkg][1]
    op = lambda w: core.make_operator("average", aion.block_size, w,  # noqa
                                      **_dev(pkg))
    return [
        core.TenantSpec(name="alpha", assigner=core.TumblingWindows(10.0),
                        operator=op(1), value_width=1, weight=2,
                        device_budget_bytes=32 << 20),
        core.TenantSpec(name="beta", assigner=core.TumblingWindows(5.0),
                        operator=op(2), value_width=2, weight=1,
                        device_budget_bytes=32 << 20),
        core.TenantSpec(name="gamma", assigner=core.TumblingWindows(20.0),
                        operator=op(1), value_width=1, weight=1,
                        device_budget_bytes=32 << 20),
    ]


def _mt(pkg, aion, specs, **kw):
    return PKGS[pkg][1].MultiTenantEngine(specs, aion=aion, **kw,
                                          **_dev(pkg))


def _drive_one(eng, seed, width, n_rounds=10, pkg="torch"):
    core = PKGS[pkg][1]
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(n_rounds):
        n = 120
        ts = rng.uniform(max(now - 8, 0), now + 1, n)
        eng.ingest(core.EventBatch(rng.integers(0, 6, n), ts,
                                   rng.normal(size=(n, width))
                                   .astype(np.float32)), now)
        eng.advance_watermark(now - 3, now)
        eng.poll(now)
        if pkg == "jax":
            # the JAX engine loses appends that race its I/O thread
            # (ROADMAP Queue 3, item 18): it steps with both idle
            if eng.pipeline is not None:
                assert eng.pipeline.drain()
            assert eng.io.drain()
        now += 2.5
    eng.advance_watermark(now + 100, now)
    return now


def _final_results(eng, now, pkg="torch"):
    bx = PKGS[pkg][2]
    if eng.pipeline is not None:
        assert eng.pipeline.drain()
    assert eng.io.drain()
    items = [bx.BatchWorkItem(wid=wid, state=st, late=True)
             for wid, st in sorted(eng.windows.items())]
    return {(w.start, w.end): r
            for w, r in eng.batch_exec.execute(items, now).items()}


WIDTHS = {"alpha": 1, "beta": 2, "gamma": 1}
SEEDS = {"alpha": 21, "beta": 22, "gamma": 23}


def _mt_results(pkg, pipelined, spill_dir):
    cfg = PKGS[pkg][0]
    aion = cfg.AionConfig(block_size=64, pipelined_execution=pipelined)
    mt = _mt(pkg, aion, _specs(aion, pkg), device_budget_bytes=256 << 20,
             spill_dir=spill_dir)
    ends = {name: _drive_one(mt.engine(name), SEEDS[name], WIDTHS[name],
                             pkg=pkg)
            for name in mt.engines}
    out = {name: _final_results(mt.engine(name), ends[name], pkg)
           for name in mt.engines}
    assert mt.executor.stats["errors"] == 0
    if pipelined:
        assert mt.pipeline.stats["rounds"] > 0
    mt.close()
    return out


def _close(got, want):
    assert set(got) == set(want)
    for wid in want:
        np.testing.assert_allclose(got[wid], want[wid], atol=ATOL,
                                   err_msg=str(wid))


# --------------------------------------------- tests/test_tenancy.py's cases
@pytest.mark.parametrize("pipelined", [False, True])
def test_multi_tenant_parity_with_standalone(pipelined, tmp_path):
    """Each tenant of the port's multi-tenant engine against its own
    standalone synchronous port engine and against the JAX
    ``MultiTenantEngine`` with the same setting, on the same streams."""
    got = _mt_results("torch", pipelined, tmp_path / "mt")
    jax_got = _mt_results("jax", pipelined, tmp_path / "jmt")
    ref_aion = tcfg.AionConfig(block_size=64)
    for spec in _specs(ref_aion):
        ref = tcore.StreamEngine(
            assigner=spec.assigner, operator=spec.operator, aion=ref_aion,
            value_width=spec.value_width,
            spill_dir=tmp_path / f"ref_{spec.name}", device="cpu")
        end = _drive_one(ref, SEEDS[spec.name], WIDTHS[spec.name])
        _close(got[spec.name], _final_results(ref, end))
        _close(got[spec.name], jax_got[spec.name])
        ref.close()


def test_tenant_budget_caps_inside_shared_parent():
    parent = MemoryBudget(1000)
    a = TenantBudget(parent, 400)
    b = TenantBudget(parent, 800)
    assert a.try_reserve(400)
    assert not a.try_reserve(1)
    assert b.try_reserve(600)
    assert not b.try_reserve(200)          # parent exhausted, cap not
    assert parent.used_bytes == 1000
    a.release(400)
    assert b.try_reserve(200)              # a's release refills the parent
    b.release(800)
    assert parent.used_bytes == 0
    assert a.used_bytes == 0 and b.used_bytes == 0


def test_tenant_budget_rolls_back_own_on_parent_failure():
    parent = MemoryBudget(100)
    a = TenantBudget(parent, 500)
    assert parent.try_reserve(80)
    assert not a.try_reserve(50)
    assert a.used_bytes == 0


def test_fairness_stats_count_per_tenant_io(tmp_path):
    aion = tcfg.AionConfig(block_size=64)
    mt = _mt("torch", aion, _specs(aion)[:2],
             device_budget_bytes=128 << 20, spill_dir=tmp_path)
    for name, eng in mt.engines.items():
        eng.ingest(_stream(31, 300, WIDTHS[name], 0.0, 9.9), now=1.0)
        eng.io.request_destage(next(iter(eng.windows.values())))
    assert mt.executor.drain(timeout=30.0)
    stats = mt.fairness_stats()
    assert stats.get("alpha", 0) > 0
    assert stats.get("beta", 0) > 0
    mt.close()


def test_duplicate_tenant_names_rejected():
    aion = tcfg.AionConfig(block_size=64)
    with pytest.raises(ValueError, match="duplicate"):
        _mt("torch", aion, _specs(aion)[:1] * 2)


def test_tenant_profiles_table_is_well_formed():
    """The port's profile table is the JAX package's."""
    names = [p.name for p in twl.TENANT_PROFILES]
    assert len(names) == 10 and len(set(names)) == 10
    assert abs(sum(p.device_budget_frac for p in twl.TENANT_PROFILES)
               - 1.0) < 1e-9
    assert abs(sum(p.host_budget_frac for p in twl.TENANT_PROFILES)
               - 1.0) < 1e-9
    assert all(p.weight >= 1 for p in twl.TENANT_PROFILES)
    assert twl.get_tenant_profile("mistral_large_123b").weight == 4
    with pytest.raises(KeyError):
        twl.get_tenant_profile("nonexistent_model")
    assert [(p.name, p.workload.name, p.weight, p.device_budget_frac,
             p.host_budget_frac) for p in twl.TENANT_PROFILES] == \
        [(p.name, p.workload.name, p.weight, p.device_budget_frac,
          p.host_budget_frac) for p in jwl.TENANT_PROFILES]


def test_from_profiles_builds_and_streams(tmp_path):
    aion = tcfg.AionConfig(block_size=64)
    profiles = [twl.get_tenant_profile("mamba2_780m"),
                twl.get_tenant_profile("qwen3_moe_30b")]
    mt = tcore.MultiTenantEngine.from_profiles(
        profiles, device_budget_bytes=256 << 20,
        host_budget_bytes=256 << 20, spill_dir=tmp_path, aion=aion,
        device="cpu")
    for p in profiles:
        eng = mt.engine(p.name)
        width = p.workload.resolved_value_width()
        mt.ingest(p.name, _stream(41, 200, width, 0.0,
                                  p.workload.window_duration - 0.1),
                  now=1.0)
        assert eng.metrics.ingested == 200
    mt.advance_watermark(1e6, now=2.0, tenant="mamba2_780m")
    mt.poll(now=2.0)
    assert len(mt.results("mamba2_780m")) >= 1
    assert mt.results("qwen3_moe_30b") == {}   # other tenant untouched
    mt.close()


# ---------------------------------------------------------- beyond the JAX
def test_from_profiles_resolves_the_device_and_builds_linear_road(tmp_path):
    """``device=None`` is the card (raises without CUDA, as every entry
    point of the port); a Linear Road profile builds on the port, where
    the JAX package's ``from_profiles`` passes ``num_keys`` to the lrb
    operator and raises ``TypeError`` (ROADMAP Queue 3)."""
    import torch
    lrb = twl.get_tenant_profile("granite_34b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.MultiTenantEngine.from_profiles([lrb])
    with pytest.raises(TypeError, match="num_keys"):
        jcore.MultiTenantEngine.from_profiles(
            [jwl.get_tenant_profile("granite_34b")],
            aion=jcfg.AionConfig(block_size=64))
    mt = tcore.MultiTenantEngine.from_profiles(
        [lrb], device_budget_bytes=64 << 20, spill_dir=tmp_path,
        aion=tcfg.AionConfig(block_size=64), device="cpu")
    assert mt.engine("granite_34b").operator.name == "lrb"
    mt.close()


def test_chip_smoke_phase_14_rehearsal(tmp_path):
    """Phase 14 at a small rate and width: four tenants of
    ``TENANT_PROFILES``, three stock tenants sharing the arena and Linear
    Road on the unpooled path, pipelined with learned prefetch; every
    window held to its oracle, I/O executed for every tenant, every fold
    kernel launched from the pipeline's worker."""
    import chip_smoke as cs
    with cs.LaunchRecorder() as recorder:
        rec = cs.run_tenants("cpu", seconds=60.0, seed=cs.SEED + 14,
                             spill_root=tmp_path, pool_slots=256,
                             device_budget=64 << 20, host_budget=1 << 20,
                             rate=200.0, widths={"stock": 8, "lrb": 6})
    t = rec["tenants"]
    assert set(t) == set(cs.TENANTS)
    assert not t["granite_34b"]["pooled"]
    assert all(t[n]["pooled"] for n in cs.TENANTS[:3])
    assert all(rec["fairness"].get(n, 0) > 0 for n in cs.TENANTS)
    assert rec["counts"]["pipeline_rounds"] > 0
    assert rec["counts"]["pooled_rows"] > 0
    assert rec["pipeline"]["round_retries"] == 0
    assert rec["events"] == 4 * 200 * 60
    for key in cs.KERNELS:
        assert set(recorder.threads[key]) <= {"aion-fold-worker"}, key
    assert recorder.threads["K2"]
