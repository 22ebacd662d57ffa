"""The port's sharded fleet and open-loop load generator against
``repro.runtime``'s, exactly, on the CPU.

Both ``runtime/fleet.py`` and ``runtime/loadgen.py`` are numpy-only copies,
so every comparison is equality (NaN equal to NaN):

  * ``OpenLoopLoadGen`` arrivals field for field and ``workload_summary`` for
    several seeds and mixes, and the same validation errors;
  * the simulated device step (``_prefill_state``, ``_advance_state``,
    ``_emit_token``; the port's in uint8, ``repro``'s in int64) bit-equal;
  * ``PlannerService`` records over ``sim_state_graph`` buckets (keys,
    ``alone_bytes``, ``persistent_bytes``, ``resident_extent``, every class
    plan's offsets and bytes) and its stats;
  * ``tests/test_fleet.py``'s scenarios run through both packages, each
    outcome compared whole: the metrics without ``wall_s``, every request's
    tokens, shard trail, preemptions, migrations and ticks, every rejection's
    code and reason, and every shard's ``report()``;
  * ``launch/serve.py:fleet_planner_for_model`` on each family's smoke
    config: keys and integers equal to ``repro``'s;
  * the ``--fleet`` CLI's lines equal to ``repro``'s for the same arguments,
    each package in a fresh process (a fresh plan cache).
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime.chaos as jchaos  # noqa: E402
import repro.runtime.fleet as jfleet  # noqa: E402
import repro.runtime.loadgen as jloadgen  # noqa: E402
import repro.runtime.pool as jpool  # noqa: E402
import repro_torch.runtime.chaos as tchaos  # noqa: E402
import repro_torch.runtime.fleet as tfleet  # noqa: E402
import repro_torch.runtime.loadgen as tloadgen  # noqa: E402
import repro_torch.runtime.pool as tpool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(fleet=jfleet, loadgen=jloadgen, chaos=jchaos,
                            pool=jpool)
PORT = types.SimpleNamespace(fleet=tfleet, loadgen=tloadgen, chaos=tchaos,
                             pool=tpool)
BUCKETS = (16, 32, 64)


def _plain(x):
    """``x`` with NaN as a string (so that NaN equals NaN), tuples as
    lists."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------- loadgen

MIXES = [
    dict(rate=2.0, latency_frac=0.3, priority_weights={0: 3.0, 1: 1.0},
         tenant_weights={"a": 1.0, "b": 1.0}),
    dict(rate=4.0, prompt_mean=48.0, prompt_min=2, prompt_max=256,
         gen_mean=8.0, gen_max=32, latency_frac=0.25),
    dict(rate=2.0, priority_weights={0: 1.0, 2: 1.0},
         tenant_weights={"t0": 3.0, "t1": 1.0}),
    dict(rate=2.0, prompt_mean=1024, gen_mean=32, latency_frac=0.25),
    dict(),
]


@pytest.mark.parametrize("mix", range(len(MIXES)))
@pytest.mark.parametrize("seed", (0, 3, 7))
def test_arrivals_equal_repro(mix, seed):
    kw = MIXES[mix]
    a = jloadgen.OpenLoopLoadGen(seed, **kw)
    b = tloadgen.OpenLoopLoadGen(seed, **kw)
    ja, ta = a.arrivals(600), b.arrivals(600)
    assert [dataclasses.astuple(x) for x in ta] == \
        [dataclasses.astuple(x) for x in ja]
    assert [x.smax for x in ta] == [x.smax for x in ja]
    assert tloadgen.workload_summary(ta) == jloadgen.workload_summary(ja)
    assert b.describe() == a.describe()
    assert tloadgen.workload_summary([]) == {"n": 0}
    assert b.arrivals(0) == []


@pytest.mark.parametrize("kw", [
    dict(rate=0.0), dict(latency_frac=1.5), dict(prompt_min=5, prompt_max=4),
    dict(gen_min=0), dict(gen_mean=0.5), dict(tenant_weights={"a": -1.0}),
    dict(priority_weights={})])
def test_loadgen_validation_equal_repro(kw):
    with pytest.raises(ValueError) as je:
        jloadgen.OpenLoopLoadGen(0, **kw)
    with pytest.raises(ValueError) as te:
        tloadgen.OpenLoopLoadGen(0, **kw)
    assert str(te.value) == str(je.value)


# ------------------------------------------------------ the simulated step


@pytest.mark.parametrize("rid,prompt,extent", [
    (0, 0, 0), (3, 1000, 1), (250, 7, 250), (251, 4, 251), (7, 33, 252),
    (1234567, 99999, 5000), (41, 1024, 34603),
    (5, 77, 3 * tfleet._STEP_SPAN + 17)])
def test_simulated_step_bits_equal_repro(rid, prompt, extent):
    a = jfleet._prefill_state(rid, prompt, extent)
    b = tfleet._prefill_state(rid, prompt, extent)
    assert b.dtype == a.dtype == np.uint8 and np.array_equal(b, a)
    for step in (0, 1, 255, 256, 1023, 10 ** 6 + 3):
        a = jfleet._advance_state(a, rid, step)
        b = tfleet._advance_state(b, rid, step)
        assert np.array_equal(b, a), step
        assert tfleet._emit_token(b, step) == jfleet._emit_token(a, step)


# ---------------------------------------------------------------- planner


def _record(rec):
    """Everything a record carries, but the graph object."""
    def plan(p):
        return dict(arena=p.arena_bytes, peak=p.peak_bytes,
                    policy=p.policy,
                    offsets=[(tuple(a.node_ids), a.offset, a.size,
                              a.t_alloc, a.t_free) for a in p.allocations])
    return dict(key=rec.key, alone=rec.alone_bytes,
                persistent=rec.persistent_bytes,
                extent=rec.resident_extent, plan=plan(rec.plan),
                classes={k: plan(v) for k, v in sorted(rec.classes.items())})


def test_planner_records_equal_repro():
    out = {}
    for name, P in (("jax", JAX), ("port", PORT)):
        svc = P.fleet.PlannerService(cache=_fresh_cache(P))
        recs = P.fleet.bucketed_records(svc, (16, 32, 64, 1056))
        again = svc.plan_graph(P.fleet.sim_state_graph(32))
        shared = P.fleet.PlannerService(cache=svc.cache)
        shared.plan_graph(P.fleet.sim_state_graph(64))
        out[name] = dict(
            records={b: _record(r) for b, r in recs.items()},
            same=again is recs[32], stats=svc.stats.as_dict(),
            shared=shared.stats.as_dict(), keys=svc.keys(),
            charge={b: (r.charge_bytes(None), r.charge_bytes("latency"))
                    for b, r in recs.items()})
    assert out["port"] == out["jax"]
    assert out["port"]["same"] and out["port"]["shared"]["shared_hits"] == 1
    with pytest.raises(KeyError, match="never plan locally"):
        tfleet.PlannerService().record("deadbeef")
    rec = tfleet.PlannerService().plan_graph(tfleet.sim_state_graph(16))
    with pytest.raises(tpool.PoolError) as ei:
        rec.plan_for("turbo")
    assert ei.value.code == "unknown_class"


def _fresh_cache(P):
    mod = sys.modules[P.fleet.PlanCache.__module__]
    return mod.PlanCache(disk_dir=None)


# ---------------------------------------------------------------- scenarios


def make_fleet(P, n_decode=2, n_prefill=0, *, slots=3, buckets=BUCKETS,
               **kw):
    planner = P.fleet.PlannerService(cache=_fresh_cache(P))
    records = P.fleet.bucketed_records(planner, buckets)
    budget = slots * records[buckets[-1]].alone_bytes
    fleet = P.fleet.Fleet(planner, key_for=P.fleet.bucket_key_for(records),
                          n_decode=n_decode, n_prefill=n_prefill,
                          shard_budget_bytes=budget, **kw)
    return fleet, records


def short_requests(P, n, records, *, gen=3, prompt=4, stagger=1, **kw):
    key = records[BUCKETS[0]].key
    return [P.fleet.FleetRequest(rid=i, key=key, prompt_len=prompt,
                                 gen_len=gen, arrival_tick=1 + i * stagger,
                                 **kw)
            for i in range(n)]


def token_map(fleet):
    return {r.rid: tuple(r.tokens) for r in fleet.done}


def outcome(fleet, m=None):
    """A fleet's whole observable result (``wall_s`` left out)."""
    out = dict(
        tokens=token_map(fleet),
        trails={r.rid: (tuple(r.shards), r.preemptions, r.migrations,
                        r.submit_tick, r.admit_tick, r.done_tick)
                for r in fleet.done},
        rejected=[(r.rid, r.reject_code, r.reject_reason)
                  for r in fleet.rejected],
        reports=[s.report() for s in fleet.shards],
        stats=fleet.stats.as_dict(), ticks=fleet.ticks)
    if m is not None:
        out["metrics"] = {k: v for k, v in m.items() if k != "wall_s"}
    return _plain(out)


def sc_spread(P):
    fleet, records = make_fleet(P, n_decode=4, slots=8)
    for r in short_requests(P, 8, records, stagger=0):
        fleet.submit(r, now=1)
    return dict(per_shard=[s.stats.submitted for s in fleet.shards],
                loads=[s.load_fraction() for s in fleet.shards])


def sc_under_budget(P):
    fleet, records = make_fleet(P, n_decode=3, slots=2)
    m = fleet.run(short_requests(P, 40, records, gen=4, stagger=1))
    return outcome(fleet, m)


def sc_oversize(P):
    fleet, records = make_fleet(P, n_decode=2, slots=2, buckets=(16, 32))
    huge = records[32]
    for s in fleet.shards:
        s.pool.set_budget(huge.alone_bytes - 1)
    req = P.fleet.FleetRequest(rid=0, key=huge.key, prompt_len=4, gen_len=2)
    fleet.submit(req, now=1)
    return dict(code=req.reject_code, reason=req.reject_reason,
                **outcome(fleet))


def sc_tenant_quota(P):
    planner = P.fleet.PlannerService(cache=_fresh_cache(P))
    records = P.fleet.bucketed_records(planner, (16,))
    charge = records[16].alone_bytes
    fleet = P.fleet.Fleet(planner, key_for=P.fleet.bucket_key_for(records),
                          n_decode=2, shard_budget_bytes=4 * charge,
                          tenant_quotas={"small": charge - 1})
    reqs = [P.fleet.FleetRequest(rid=i, key=records[16].key, prompt_len=2,
                                 gen_len=2, tenant=t)
            for i, t in enumerate(("small", "big"))]
    for r in reqs:
        fleet.submit(r, now=1)
    return dict(codes=[r.reject_code for r in reqs], **outcome(fleet))


def sc_all_rejected(P):
    fleet, records = make_fleet(P, n_decode=2, slots=2, buckets=(16, 32))
    for s in fleet.shards:
        s.pool.set_budget(1)
    return outcome(fleet, fleet.run(short_requests(P, 3, records)))


def sc_open_loop(P):
    fleet, records = make_fleet(P, n_decode=2, slots=4)
    gen = P.loadgen.OpenLoopLoadGen(5, rate=1.0, prompt_mean=8.0,
                                    prompt_max=30, gen_mean=4.0, gen_max=10,
                                    latency_frac=0.25)
    return outcome(fleet, fleet.run_arrivals(gen.arrivals(120)))


def sc_fleet_shapes(P):
    gen = P.loadgen.OpenLoopLoadGen(11, rate=1.5, prompt_mean=10.0,
                                    prompt_max=40, gen_mean=4.0, gen_max=12)
    arr = gen.arrivals(80)
    out = {}
    for n_decode in (1, 4):
        fleet, _ = make_fleet(P, n_decode=n_decode, slots=4)
        out[n_decode] = outcome(fleet, fleet.run_arrivals(arr))
    assert out[1]["tokens"] == out[4]["tokens"]
    return out


def sc_latency_class(P):
    fleet, records = make_fleet(P, n_decode=1, slots=8, max_batch=2)
    key = records[BUCKETS[0]].key
    reqs = [P.fleet.FleetRequest(rid=i, key=key, prompt_len=2, gen_len=4,
                                 klass=("latency" if i % 2 else "memory"),
                                 arrival_tick=1)
            for i in range(6)]
    return outcome(fleet, fleet.run(reqs))


def sc_handoff(P):
    out = {}
    for n_prefill in (0, 1):
        fleet, records = make_fleet(P, n_decode=2, n_prefill=n_prefill,
                                    slots=4, prefill_chunk=8)
        key = records[BUCKETS[-1]].key
        reqs = [P.fleet.FleetRequest(rid=i, key=key, prompt_len=40,
                                     gen_len=3, arrival_tick=1 + i)
                for i in range(16)]
        out[n_prefill] = outcome(fleet, fleet.run(reqs))
    assert out[1]["metrics"]["handoffs"] == 16
    assert out[1]["metrics"]["prefill_stall_ticks"] == 0
    assert out[0]["metrics"]["prefill_stall_ticks"] > 0
    assert out[0]["tokens"] == out[1]["tokens"]
    return out


def sc_short_prompts(P):
    fleet, records = make_fleet(P, n_decode=2, n_prefill=1, slots=4,
                                prefill_chunk=8)
    return outcome(fleet, fleet.run(short_requests(P, 10, records,
                                                   prompt=4)))


def _mig_workload(P, records, n=24):
    key = records[BUCKETS[0]].key
    return [P.fleet.FleetRequest(rid=i, key=key, prompt_len=4, gen_len=6,
                                 arrival_tick=1 + i // 2, priority=i % 2)
            for i in range(n)]


def sc_migration(P):
    plan = P.chaos.FaultPlan([P.chaos.FaultSpec("budget_shrink", 3, 0.05)])
    fleet, records = make_fleet(P, n_decode=2, slots=4, buckets=(16,),
                                fault_plans={0: plan})
    out = outcome(fleet, fleet.run(_mig_workload(P, records)))
    assert out["metrics"]["migrations"] > 0
    assert out["metrics"]["max_over_budget"] <= 0
    return out


def sc_readmit_exhaustion(P):
    fleet, records = make_fleet(P, n_decode=1, slots=4,
                                max_readmit_attempts=2)
    shard = fleet.shards[0]
    reqs = [P.fleet.FleetRequest(rid=i, key=records[BUCKETS[0]].key,
                                 prompt_len=4, gen_len=6, arrival_tick=1)
            for i in range(3)]
    orig_tick = shard.tick

    def tick(now, fl):
        if now == 2:
            shard.set_budget(1, fl, now)
            shard.pool.admission_hook = lambda: True
        orig_tick(now, fl)

    shard.tick = tick
    out = outcome(fleet, fleet.run(reqs))
    assert out["rejected"] and out["metrics"]["n_lost"] == 0
    return out


def sc_chaos_corpus(P):
    base, records = make_fleet(P, n_decode=2, slots=3)
    out = {"base": outcome(base, base.run(_mig_workload(P, records)))}
    for seed in range(6):
        plans = {sid: P.chaos.FaultPlan.generate(seed + 17 * sid, n_ticks=10,
                                                 rate=0.35)
                 for sid in range(2)}
        fleet, records = make_fleet(P, n_decode=2, slots=3,
                                    fault_plans=plans)
        o = outcome(fleet, fleet.run(_mig_workload(P, records)))
        m = o["metrics"]
        assert m["n_lost"] == 0 and m["max_over_budget"] <= 0
        assert m["n_served"] + m["n_rejected"] == m["n_requests"]
        for rid, toks in o["tokens"].items():
            assert toks == out["base"]["tokens"][rid]
        out[seed] = o
    return out


def sc_local_planning(P):
    fleet, _ = make_fleet(P, n_decode=1)
    with pytest.raises(P.pool.PoolError) as ei:
        fleet.shards[0].pool.submit(P.fleet.sim_state_graph(128))
    return ei.value.code


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_spread, sc_under_budget, sc_oversize, sc_tenant_quota,
    sc_all_rejected, sc_open_loop, sc_fleet_shapes, sc_latency_class,
    sc_handoff, sc_short_prompts, sc_migration, sc_readmit_exhaustion,
    sc_chaos_corpus, sc_local_planning)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_repro(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want


def test_scenario_codes():
    # the codes the fleet's rejections carry are the pool's own
    assert SCENARIOS["oversize"](PORT)["code"] == "budget"
    assert SCENARIOS["tenant_quota"](PORT)["codes"] == ["tenant_quota", ""]
    assert SCENARIOS["local_planning"](PORT) == "no_local_planning"
    m = SCENARIOS["all_rejected"](PORT)["metrics"]
    assert m["p50_ticks"] == m["p99_ticks"] == "nan"
    assert SCENARIOS["spread"](PORT)["per_shard"] == [2, 2, 2, 2]


# ------------------------------------------------------ real decode plans

FAMILIES = ("llama3.2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
            "rwkv6-7b", "recurrentgemma-2b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", FAMILIES)
def test_fleet_planner_for_model_equal_repro(arch):
    import repro.configs as jconfigs
    import repro.launch.serve as jserve
    import repro.models.zoo as jzoo
    import repro_torch.configs as tconfigs
    import repro_torch.launch.serve as tserve
    import repro_torch.models.zoo as tzoo
    buckets = (40, 80, 320)
    _, jrec = jserve.fleet_planner_for_model(
        jzoo.build_model(jconfigs.smoke(arch)), buckets)
    tsvc, trec = tserve.fleet_planner_for_model(
        tzoo.build_model(tconfigs.smoke(arch)), buckets)
    assert {b: _record(r) for b, r in trec.items()} == \
        {b: _record(r) for b, r in jrec.items()}
    # (rwkv6-7b's state does not grow with the sequence: one key for all)
    assert tsvc.keys() == tuple(dict.fromkeys(r.key for r in trec.values()))
    # the records are the single-device server's plans, by fingerprint
    plan = tserve.plan_decode_arena(tzoo.build_model(tconfigs.smoke(arch)),
                                    1, 80)
    assert trec[80].plan is plan["plan"]
    assert trec[80].resident_extent == plan["resident_extent"]


def _model_fleet(model, arrivals, buckets, fault_plans=None):
    """``run_fleet``'s fleet over ``model``'s decode plans (2 decode and 1
    prefill shards, its default budget), built from the planner's records
    so that its requests' token streams can be read; (metrics, fleet)."""
    import repro_torch.launch.serve as tserve
    planner, records = tserve.fleet_planner_for_model(model, buckets)
    fleet = tfleet.Fleet(
        planner, key_for=tfleet.bucket_key_for(records), n_decode=2,
        n_prefill=1, shard_budget_bytes=8 * records[buckets[-2]].alone_bytes,
        fault_plans=fault_plans)
    return fleet.run_arrivals(arrivals), fleet


def test_run_fleet_equal_repro():
    import repro.configs as jconfigs
    import repro.launch.serve as jserve
    import repro.models.zoo as jzoo
    import repro_torch.configs as tconfigs
    import repro_torch.launch.serve as tserve
    import repro_torch.models.zoo as tzoo
    kw = dict(rate=2.0, prompt_mean=24, prompt_max=128, gen_mean=6,
              gen_max=12, latency_frac=0.25)
    arr = jloadgen.OpenLoopLoadGen(2, **kw).arrivals(60)
    tarr = tloadgen.OpenLoopLoadGen(2, **kw).arrivals(60)
    plans = {0: (jchaos.FaultPlan.generate(3, n_ticks=8, rate=0.4),
                 tchaos.FaultPlan.generate(3, n_ticks=8, rate=0.4))}
    clean = None
    for faults in (None, plans):
        jm = jserve.run_fleet(
            jzoo.build_model(jconfigs.smoke("llama3.2-1b")), arr,
            buckets=(32, 64, 256), n_decode=2, n_prefill=1,
            fault_plans=faults and {k: v[0] for k, v in faults.items()})
        tm = tserve.run_fleet(
            tzoo.build_model(tconfigs.smoke("llama3.2-1b")), tarr,
            buckets=(32, 64, 256), n_decode=2, n_prefill=1,
            fault_plans=faults and {k: v[1] for k, v in faults.items()})
        jm.pop("wall_s"), tm.pop("wall_s")
        assert _plain(tm) == _plain(jm)
        assert tm["n_lost"] == 0 and tm["max_over_budget"] <= 0
        clean = clean if faults else tm
    # the same fleet built from the planner's records, as chip_smoke.py
    # builds it for the token streams: the same run
    fm, fleet = _model_fleet(tzoo.build_model(tconfigs.smoke("llama3.2-1b")),
                             tarr, (32, 64, 256))
    fm.pop("wall_s")
    assert set(clean) - set(fm) == {"shard_budget_bytes", "buckets"}
    assert _plain(fm) == _plain({k: clean[k] for k in fm})
    assert sum(len(r.tokens) for r in fleet.done) == fm["tokens"]


def test_run_fleet_in_threads_equal_sequential():
    # fleets run in threads over one model and the process-wide plan cache
    # (chip_smoke.fleet_runs(pool="threads"), tools/fleet_host_probe.py):
    # each must equal its run alone
    import concurrent.futures

    import repro_torch.configs as tconfigs
    import repro_torch.launch.serve as tserve
    import repro_torch.models.zoo as tzoo
    model = tzoo.build_model(tconfigs.smoke("llama3.2-1b"))
    arr = tloadgen.OpenLoopLoadGen(4, rate=2.0, prompt_mean=24,
                                   prompt_max=128, gen_mean=6,
                                   gen_max=12).arrivals(40)

    def run(seed):
        plans = {sid: tchaos.FaultPlan.generate(seed + 17 * sid, n_ticks=30,
                                                rate=0.1)
                 for sid in range(3)}
        m, fleet = _model_fleet(model, arr, (32, 64, 256), plans)
        m.pop("wall_s")
        return _plain(m), token_map(fleet)

    alone = [run(seed) for seed in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(12) as ex:
            together = list(ex.map(run, range(12), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert together == alone


# ---------------------------------------------------------------- the CLI


def _cli(module, args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_PLANCACHE_DIR", "REPRO_TORCH_PLANCACHE_DIR")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return [ln for ln in out.stdout.splitlines()
            if ln.startswith(("[fleet]", "[serve]"))]


@pytest.mark.parametrize("args", [
    ["--smoke", "--fleet", "4", "--prefill-shards", "1", "--rate", "2.0",
     "--requests", "40", "--prompt-len", "48", "--gen", "8"],
    ["--smoke", "--fleet", "2", "--prefill-shards", "0", "--rate", "3.0",
     "--requests", "24", "--seed", "3"]])
def test_cli_fleet_lines_equal_repro(args):
    args = ["--arch", "llama3.2-1b", *args]
    want = _cli("repro.launch.serve", args)
    got = _cli("repro_torch.launch.serve", args)
    assert sum(ln.startswith("[fleet]") for ln in got) == 3
    assert got == want
