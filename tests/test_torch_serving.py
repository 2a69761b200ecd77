"""The port's serving path on the CPU against the JAX package's: the metrics
registry and its text exposition, slot clocks, the span tracer, the
router's latency table and decisions, the batch policy, the beacon
processor's pop order and batches, and the continuous-batch scheduler's
close causes, stats, per-job verdicts and metrics, with the same fake
backends registered in both signature APIs and the same fake clocks. Also
the seams that order the async dispatch on the card (the graph lock's
tail, the stage timer's settling), with stand-ins for CUDA streams and
events, and the shape warmer's policy hook. Nothing here verifies a
signature: tests/test_torch_cpu_route.py runs both routes."""

import dataclasses
import random

import pytest

from lighthouse_tpu.beacon_processor import processor as jproc
from lighthouse_tpu.common import metrics as jm
from lighthouse_tpu.common import slot_clock as jclock
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.observability import trace as jtrace
from lighthouse_tpu.serving import router as jrouter
from lighthouse_tpu.serving import scheduler as jsched
from lighthouse_tpu_torch.beacon_processor import processor as pproc
from lighthouse_tpu_torch.beacon_processor import warming
from lighthouse_tpu_torch.common import metrics as pm
from lighthouse_tpu_torch.common import slot_clock as pclock
from lighthouse_tpu_torch.crypto.bls import api as papi
from lighthouse_tpu_torch.observability import stages
from lighthouse_tpu_torch.observability import trace as ptrace
from lighthouse_tpu_torch.ops import backend, graphs
from lighthouse_tpu_torch.serving import router as prouter
from lighthouse_tpu_torch.serving import scheduler as psched

JAX = dict(metrics=jm, clock=jclock, proc=jproc, router=jrouter, sched=jsched, api=japi)
PORT = dict(metrics=pm, clock=pclock, proc=pproc, router=prouter, sched=psched, api=papi)
# The JAX router registers the counter of its device-to-CPU retry, which
# the port does not have (by design: a device failure propagates).
FALLBACK = ("# HELP serving_router_fallback_total Device-route failures retried on the "
            "native CPU route\n# TYPE serving_router_fallback_total counter\n")


def _without_fallback(text: str) -> str:
    assert text.count(FALLBACK) == 1
    return text.replace(FALLBACK, "")


def _metric_ops(m):
    reg = m.Registry()
    reg.counter("a_total", "plain").inc(3)
    c = reg.counter_vec("b_total", "labeled", labels=("route", "reason"))
    c.labels(route="cpu", reason="small").inc()
    c.labels("device", 'we"ird\\\nvalue').inc(2.5)
    g = reg.gauge_vec("depth", "gauges", "kind")
    g.labels("x").set(7)
    g.labels("y").inc(2)
    g.labels("y").dec(0.5)
    reg.gauge("g", "one").set(-1.25)
    h = reg.histogram("h_seconds", "hist", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 20.0):
        h.observe(v)
    hv = reg.histogram_vec("hv_seconds", "hist vec", labels=("engine", "stage"),
                           buckets=(0.001, 0.01))
    hv.labels(engine="gpu", stage="h2g2").observe(0.005)
    hv.labels("gpu", "pairing").observe(1.0)
    assert reg.counter_vec("b_total") is c and len(reg) == 6 and bool(m.Registry())
    return reg.gather(), c.get("device", 'we"ird\\\nvalue'), hv.get_count("gpu", "h2g2")


def test_metrics_exposition_matches_jax():
    assert _metric_ops(pm) == _metric_ops(jm)


def test_slot_clocks_match_jax():
    out = []
    for mod in (jclock, pclock):
        c = mod.ManualSlotClock(genesis_time=100, seconds_per_slot=12, genesis_slot=3)
        rows = [(c.now(), c.seconds_into_slot(), c.duration_to_next_slot())]
        c.advance_seconds(-1)
        rows.append((c.now(), c.now_or_genesis(), c.seconds_into_slot()))
        for step in (1.5, 12, 30.25):
            c.advance_seconds(step)
            rows.append((c.now(), c.seconds_into_slot(), c.duration_to_next_slot()))
        c.set_slot(9)
        c.advance_slot(2)
        rows.append((c.now(), c.start_of(4)))
        rows.append(mod.SystemTimeSlotClock(0, 12).now() > 0)
        out.append(rows)
    assert out[0] == out[1]


def test_tracer_records_as_jax():
    def run(mod):
        t = mod.Tracer(max_events=5)
        with t.span("off"):
            pass
        t.enable()
        with t.span("outer", cat="stage", n=4):
            with t.span("inner"):
                t.instant("mark", k=1)
        t.counter_series("depth", q=3)
        for i in range(4):
            t.instant(f"extra{i}")
        ev = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
              for e in t.events()]
        return ev, t.export()["otherData"]["dropped_events"]

    assert run(ptrace) == run(jtrace)
    assert ptrace.export()["otherData"]["producer"] == "lighthouse_tpu_torch.observability"


def _table_ops(mod, seed):
    rng = random.Random(seed)
    table = mod.LatencyTable()
    for _ in range(rng.randrange(0, 12)):
        route, b = rng.choice(("cpu", "device")), 1 << rng.randrange(0, 15)
        getattr(table, rng.choice(("seed", "observe")))(route, b, rng.uniform(0.001, 0.5))
    return table


@pytest.mark.parametrize("seed", range(6))
def test_latency_table_predictions_match_jax(seed):
    tables = [_table_ops(mod, seed) for mod in (jrouter, prouter)]
    grid = [(r, b) for r in ("cpu", "device") for b in (1, 2, 3, 16, 100, 1024, 4096, 16384)]
    assert [tables[1].predict(*k) for k in grid] == [tables[0].predict(*k) for k in grid]
    assert tables[1].snapshot() == tables[0].snapshot()


@pytest.mark.parametrize("seed", range(6))
def test_router_decisions_match_jax(seed):
    routers = [mod.CostModelRouter(table=_table_ops(mod, seed), registry=m.Registry())
               for mod, m in ((jrouter, jm), (prouter, pm))]
    grid = [(n, budget) for n in (0, 1, 15, 16, 17, 64, 100, 1000, 4096, 5000)
            for budget in (None, 0.0, 0.015, 0.05, 0.1, 0.3, 2.0)]
    assert [routers[1].route(*k) for k in grid] == [routers[0].route(*k) for k in grid]
    assert routers[1].backend_name("device") == "gpu"
    assert routers[1].backend_name("cpu") == routers[0].backend_name("cpu") == "cpu"


def test_router_restores_a_table_as_jax():
    entries = {"cpu:1": 0.004, "device:4096": "0.12", "gpu:8": 1.0, "cpu:x": 1,
               "device:0": 1.0, "cpu:16": -1, "device:64": 0.08}
    got = []
    for mod, m in ((jrouter, jm), (prouter, pm)):
        reg = m.Registry()
        r = mod.CostModelRouter(registry=reg)
        got.append((r.restore_table(entries), r.table.snapshot(),
                    reg.counter("serving_router_table_restored_total").get()))
    assert got[0] == got[1] and got[0][0] == 3


def _policy_ops(policy, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        op = rng.random()
        if op < 0.4:
            policy.note_ran(rng.randrange(0, 9000))
        elif op < 0.5:
            out.append(policy.set_max_bucket(rng.randrange(-3, 20000)))
        out.append(policy.batch_limit(rng.randrange(0, 20000)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_batch_policy_matches_jax(seed):
    port = pproc.AdaptiveBatchPolicy()
    assert port.max_bucket == backend.max_n_bucket() == 16384
    assert _policy_ops(port, seed) == _policy_ops(jproc.AdaptiveBatchPolicy(max_bucket=16384), seed)


@dataclasses.dataclass(frozen=True)
class FakeSet:
    message: bytes
    valid: bool


def _processor_run(mods, seed, adaptive):
    m, proc = mods["metrics"], mods["proc"]
    reg = m.Registry()
    policy = proc.AdaptiveBatchPolicy(max_bucket=4096, warm=(8,)) if adaptive else None
    bp = proc.BeaconProcessor(max_batch=16, batch_policy=policy, registry=reg)
    rng = random.Random(seed)
    done = []
    for i in range(600):
        kind = rng.choice(proc.PRIORITY)
        batch = (lambda items, kind=kind: done.append((kind, len(items)))) \
            if kind in proc.BATCHABLE and rng.random() < 0.9 else None
        bp.send(proc.WorkEvent(kind=kind, item=i,
                               process_individual=lambda item, kind=kind: done.append((kind, 1)),
                               process_batch=batch))
        if rng.random() < 0.05:
            bp.step()
    steps = bp.run_until_idle()
    return done, steps, dataclasses.asdict(bp.stats), reg.gather()


@pytest.mark.parametrize("adaptive", [False, True])
def test_beacon_processor_pops_and_batches_as_jax(adaptive):
    assert pproc.QUEUE_CAPS == jproc.QUEUE_CAPS and pproc.PRIORITY == jproc.PRIORITY
    assert pproc.BATCHABLE == jproc.BATCHABLE
    assert _processor_run(PORT, 7, adaptive) == _processor_run(JAX, 7, adaptive)


class FakeTime:
    """perf_counter for the router and scheduler modules: the fake backends
    advance it by a cost model, so that measured latencies and deadline
    hits are the same in both runs."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t


def _scheduler_run(mods, seed, monkeypatch):
    m, clock_mod, proc, router_mod, sched_mod, api = (
        mods[k] for k in ("metrics", "clock", "proc", "router", "sched", "api"))
    fake = FakeTime()
    monkeypatch.setattr(router_mod, "time", fake)
    monkeypatch.setattr(sched_mod, "time", fake)

    def backend_fn(per_set, fixed):
        def verify(sets, device=None):
            fake.t += fixed + per_set * len(sets)
            return all(s.valid for s in sets)
        return verify

    monkeypatch.setitem(api._BACKENDS, "fake_cpu", backend_fn(0.004, 0.001))
    monkeypatch.setitem(api._BACKENDS, "fake_device", backend_fn(2e-5, 0.06))
    reg = m.Registry()
    clock = clock_mod.ManualSlotClock(genesis_time=0, seconds_per_slot=12)
    policy = proc.AdaptiveBatchPolicy(max_bucket=16384) if mods is JAX else proc.AdaptiveBatchPolicy()
    router = router_mod.CostModelRouter(cpu_backend="fake_cpu", device_backend="fake_device",
                                        registry=reg)
    sched = sched_mod.ContinuousBatchScheduler(clock, policy, router, registry=reg)
    rng = random.Random(seed)
    verdicts, expected, stepped = [], [], []

    def submit(count):
        for _ in range(count):
            i = len(verdicts)
            verdicts.append(None)
            expected.append(rng.random() > 0.02)
            job = sched_mod.VerifyJob(
                kind=rng.choice(sched_mod.BATCH_KINDS),
                sset=FakeSet(bytes([rng.randrange(6)]), expected[-1]),
                on_result=lambda ok, i=i: verdicts.__setitem__(i, ok), t_arrival=fake.t)
            assert sched.submit(job)

    for _ in range(30):
        submit(rng.choice((0, 1, 3, 40, 300)))
        clock.advance_seconds(rng.uniform(0.0, 1.5))
        stepped.append([sched.step() for _ in range(3)])
    sched.run_until_idle()
    # One job alone: it waits while the budget lasts, and closes on its
    # deadline 10 ms before the slot third ends.
    submit(1)
    stepped.append([sched.step()])
    clock.advance_seconds(sched.deadline_budget() - 0.01)
    stepped.append([sched.step()])
    # One more alone, left to the final drain.
    submit(1)
    clock.advance_seconds(0.02)
    stepped.append([sched.step()])
    drained = sched.run_until_idle()
    close = reg.counter_vec("serving_scheduler_close_total")
    causes = {c: close.get(c) for c in ("bucket_full", "deadline", "flush")}
    text = reg.gather()
    if mods is JAX:
        text = _without_fallback(text)
    return (verdicts, expected, stepped, drained, causes, dataclasses.asdict(sched.stats),
            router.table.snapshot(), sorted(policy.warm), text)


@pytest.mark.parametrize("seed", [3, 11])
def test_scheduler_matches_jax(seed, monkeypatch):
    jax_run = _scheduler_run(JAX, seed, monkeypatch)
    port_run = _scheduler_run(PORT, seed, monkeypatch)
    assert port_run == jax_run
    verdicts, expected, _, _, causes, stats, *_ = port_run
    assert verdicts == expected and False in expected
    assert stats["poisoned"] == expected.count(False)
    assert all(causes.values()), causes       # every close cause happened
    assert set(stats["by_route"]) == {"cpu", "device"}


class _Stream:
    def __init__(self):
        self.waited = []

    def wait_event(self, event):
        self.waited.append(event)


def test_graph_lock_orders_other_streams_behind_its_tail():
    lock = graphs.key_lock(("test_torch_serving", "tail"))
    assert graphs.key_lock(("test_torch_serving", "tail")) is lock
    a, b = _Stream(), _Stream()
    with lock:
        lock.follow(a)                    # no work queued yet: nothing to wait for
        lock._tail = ("event", a)         # what mark(a) leaves
        lock.follow(a)
        lock.follow(b)
        with lock:                        # reentrant, as a chain's graphs take it
            pass
    assert a.waited == [] and b.waited == ["event"]


class _Event:
    def __init__(self, done, t):
        self.done, self.t, self.waited = done, t, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_stage_marks_are_observed_once_their_events_complete():
    hist = stages.stage_seconds(pm.Registry())
    child = hist.labels(engine="gpu", stage="h2g2")
    first, second = (_Event(True, 0.0), _Event(True, 4.0)), (_Event(True, 0.0), _Event(False, 9.0))
    assert not stages._PENDING
    with stages._PENDING_LOCK:
        stages._PENDING.extend([(child, *first), (child, *second)])
    assert stages.settle() == 1 and len(stages._PENDING) == 1
    assert child.snapshot()[1:] == (1, 0.004)
    assert stages.settle(wait=True) == 1 and not stages._PENDING and second[1].waited
    assert child.snapshot()[1:] == (2, pytest.approx(0.013))


def test_stage_timing_is_off_by_default_and_names_match_jax():
    from lighthouse_tpu.observability import stages as jstages

    assert stages.STAGE_BUCKETS == jstages.STAGE_BUCKETS
    assert not stages.timing_active()
    calls = []
    wrapped = stages.traced("gpu", "h2g2", lambda x: calls.append(x) or x)
    assert wrapped(5) == 5 and calls == [5] and wrapped.__wrapped__ is not None
    regs = [pm.Registry(), jm.Registry()]
    stages.stage_seconds(regs[0]).labels("gpu", "h2g2").observe(0.002)
    jstages.stage_seconds(regs[1]).labels("gpu", "h2g2").observe(0.002)
    assert regs[0].gather() == regs[1].gather()


def test_warmer_raises_the_batch_cap_as_it_warms(monkeypatch):
    monkeypatch.setattr(warming.ShapeWarmer, "warm_one", lambda self, n, k: None)
    policy = pproc.AdaptiveBatchPolicy()
    assert policy.batch_limit(5000) == 128                   # twice the warm 64
    w = warming.ShapeWarmer(policy=policy, shapes=((256, 1), (2048, 4)), device="cpu").start()
    w.join(timeout=10)
    assert not w._thread.is_alive() and w.warmed == [(256, 1), (2048, 4)]
    assert policy.batch_limit(5000) == 4096 and policy.batch_limit(300) == 256
    w.stop()

