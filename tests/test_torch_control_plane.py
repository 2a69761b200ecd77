"""The port's serving control plane against the JAX package's, on the CPU:
the metric time-series (deltas, rates, quantiles over a seeded metric
stream), the SLO engine's evaluations, the autotuner's decisions and
policy over the real scheduler, router and batch policy with fake
backends and clocks (as tests/test_torch_serving.py drives them),
``apply_policy`` and its kill switch, ``tuned_shape_grid``, the policy
manifest read across the two packages both ways, the provenance events
from a stand-in kernel build, native build and graph capture, the probe
report envelope, and the metric names the port registers against
scripts/lint_metrics.py's contract. Nothing here imports jax: the JAX
modules compared are its jax-free control plane."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import random
import threading
import types
from pathlib import Path

import pytest
import torch

from lighthouse_tpu.beacon_processor import processor as jproc
from lighthouse_tpu.beacon_processor import warming as jwarming
from lighthouse_tpu.common import metrics as jm
from lighthouse_tpu.common import slot_clock as jclock
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.observability import report as jreport
from lighthouse_tpu.observability import slo as jslo
from lighthouse_tpu.observability import timeseries as jts
from lighthouse_tpu.serving import aot as jaot
from lighthouse_tpu.serving import autotune as jauto
from lighthouse_tpu.serving import router as jrouter
from lighthouse_tpu.serving import scheduler as jsched
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.beacon_processor import processor as pproc
from lighthouse_tpu_torch.beacon_processor import warming as pwarming
from lighthouse_tpu_torch.common import metrics as pm
from lighthouse_tpu_torch.common import slot_clock as pclock
from lighthouse_tpu_torch.crypto.bls import api as papi
from lighthouse_tpu_torch.observability import compile_events
from lighthouse_tpu_torch.observability import report as preport
from lighthouse_tpu_torch.observability import slo as pslo
from lighthouse_tpu_torch.observability import timeseries as pts
from lighthouse_tpu_torch.ops import _build, graphs
from lighthouse_tpu_torch.serving import aot as paot
from lighthouse_tpu_torch.serving import autotune as pauto
from lighthouse_tpu_torch.serving import router as prouter
from lighthouse_tpu_torch.serving import scheduler as psched

ROOT = Path(__file__).resolve().parent.parent
JAX = dict(m=jm, ts=jts, slo=jslo, auto=jauto, aot=jaot, proc=jproc, clock=jclock,
           router=jrouter, sched=jsched, api=japi)
PORT = dict(m=pm, ts=pts, slo=pslo, auto=pauto, aot=paot, proc=pproc, clock=pclock,
            router=prouter, sched=psched, api=papi)
# The JAX router registers the counter of its device-to-CPU retry, which the
# port does not have (a device failure propagates): the stock SLO on its rate
# has evidence in JAX only.
FALLBACK = "serving_router_fallback_total"


def _exposition(reg):
    """A registry's text, less the JAX-only fallback counter and the
    objective that reads it."""
    return [line for line in reg.gather().splitlines()
            if FALLBACK not in line and "route_fallback_rate" not in line]


# --- time-series and SLOs ------------------------------------------------------


def _stream(mods, seed):
    """A seeded metric stream into a fresh registry, sampled on a manual
    clock; -> (TimeSeries, registry, sample times)."""
    m = mods["m"]
    reg = m.Registry()
    c = reg.counter("x_total", "c")
    lc = reg.counter_vec("y_total", "lc", "route")
    g = reg.gauge("z_depth", "g")
    h = reg.histogram("w_seconds", "h", buckets=(-0.5, 0.0, 0.1, 0.5, 2.0))
    lh = reg.histogram_vec("v_seconds", "lh", labels=("engine", "stage"), buckets=(0.01, 0.1, 1.0))
    ts = mods["ts"].TimeSeries(reg, capacity=64)
    rng = random.Random(seed)
    times = []
    t = 0.0
    for step in range(40):
        c.inc(rng.randrange(0, 5))
        lc.labels(rng.choice(("cpu", "device"))).inc(rng.random())
        g.set(rng.uniform(-3, 3))
        for _ in range(rng.randrange(0, 6)):
            h.observe(rng.uniform(-1, 3))
            lh.labels("gpu", rng.choice(("h2g2", "pairing"))).observe(rng.uniform(0, 1.5))
        if step == 20:
            reg.counter("late_total", "born mid-stream").inc(3)
        t += rng.uniform(0.5, 4.0)
        ts.sample(now=t)
        times.append(t)
    return ts, reg, times


def _queries(ts, times):
    out = [len(ts), ts.describe(), ts.value("x_total"), ts.value("y_total", labels=None),
           ts.value("y_total", ("cpu",)), ts.value("z_depth"), ts.value("nope")]
    for window in (None, 1.0, 5.0, 30.0, 1e6):
        for now in (None, times[-1], times[-1] + 10):
            out.append([ts.delta("x_total", window, now=now),
                        ts.delta("y_total", window, labels=None, now=now),
                        ts.rate("y_total", window, ("device",), now),
                        ts.delta("late_total", window, now=now),
                        ts.hist_delta("w_seconds", window, now=now),
                        ts.mean("v_seconds", window, ("gpu", "pairing"), now),
                        [ts.quantile("w_seconds", q, window, now=now) for q in (0.0, 0.5, 0.99)],
                        [ts.quantile("v_seconds", q, window, ("gpu", "h2g2"), now)
                         for q in (0.1, 0.5, 0.9)]])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_timeseries_queries_match_jax(seed):
    got = [_queries(*(lambda ts, reg, times: (ts, times))(*_stream(mods, seed)))
           for mods in (JAX, PORT)]
    assert got[1] == got[0]
    assert pts._hist_quantile((1.0, 2.0), (0, 0, 0), 0.5) is None
    assert bool(pts.TimeSeries(pm.Registry()))


def _slo_run(mods, seed):
    ts, reg, times = _stream(mods, seed)
    objectives = (
        mods["slo"].Objective("hit", "ratio_min", 0.5, "x_total", bad_metric="y_total",
                              bad_labels=("cpu",), min_events=2),
        mods["slo"].Objective("p90", "quantile_max", 1.0, "w_seconds", q=0.9, min_events=3),
        mods["slo"].Objective("route", "rate_max", 0.3, "y_total", labels=("device",)),
        mods["slo"].Objective("starved", "quantile_max", 0.1, "v_seconds",
                              labels=("gpu", "h2g2"), min_events=10_000),
    )
    engine = mods["slo"].SloEngine(ts, objectives, window_s=8.0, registry=reg)
    evals = [{k: v.as_dict() for k, v in engine.evaluate(now=t).items()}
             for t in (times[5], times[-1], times[-1] + 20)]
    stock = [o.__dict__ for o in mods["slo"].serving_objectives()]
    return evals, engine.snapshot(), stock, reg.gather()


@pytest.mark.parametrize("seed", range(3))
def test_slo_evaluations_match_jax(seed):
    assert _slo_run(PORT, seed) == _slo_run(JAX, seed)
    assert pslo.KINDS == jslo.KINDS
    with pytest.raises(ValueError):
        pslo.Objective("bad", "ratio_min", 0.5, "x_total")


# --- the autotuner over the serving stack ----------------------------------------


class FakeTime:
    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def time(self):
        return self.t


@dataclasses.dataclass(frozen=True)
class FakeSet:
    message: bytes
    valid: bool


def _stack(mods, monkeypatch, fake):
    """A scheduler over a router with fake cpu and device backends (their
    cost models advance the fake clock) and the batch policy, as
    tests/test_torch_serving.py builds it; -> (registry, clock, scheduler)."""
    m, api = mods["m"], mods["api"]
    monkeypatch.setattr(mods["router"], "time", fake)
    monkeypatch.setattr(mods["sched"], "time", fake)

    def backend_fn(per_set, fixed):
        def verify(sets, device=None):
            fake.t += fixed + per_set * len(sets)
            return all(s.valid for s in sets)
        return verify

    monkeypatch.setitem(api._BACKENDS, "fake_cpu", backend_fn(0.004, 0.001))
    monkeypatch.setitem(api._BACKENDS, "fake_device", backend_fn(2e-5, 0.03))
    reg = m.Registry()
    clock = mods["clock"].ManualSlotClock(genesis_time=0, seconds_per_slot=12)
    policy = (mods["proc"].AdaptiveBatchPolicy(max_bucket=4096) if mods is JAX
              else mods["proc"].AdaptiveBatchPolicy())
    router = mods["router"].CostModelRouter(cpu_backend="fake_cpu",
                                            device_backend="fake_device", registry=reg)
    return reg, clock, mods["sched"].ContinuousBatchScheduler(clock, policy, router, registry=reg)


def _autotune_run(mods, monkeypatch, seed):
    """The autotuner stepped between drains of seeded traffic: late bursts
    first (deadline misses), then healthy slots of mixed sizes and message
    counts."""
    fake = FakeTime()
    reg, clock, sched = _stack(mods, monkeypatch, fake)
    ts = mods["ts"].TimeSeries(reg)
    slo = mods["slo"].SloEngine(ts, registry=reg)
    at = mods["auto"].Autotuner(scheduler=sched, batch_policy=sched.policy, timeseries=ts,
                                slo=slo, registry=reg, min_batches=2, enabled=True)
    rng = random.Random(seed)
    steps, evals = [], []
    now = 0.0
    at.step(now=now)
    for rnd in range(14):
        clock.set_slot(10 + rnd)
        if rnd < 4:
            clock.advance_seconds(4.0 - 1e-6)
        for _ in range(rng.choice((1, 4, 40, 300))):
            sched.submit(mods["sched"].VerifyJob(
                rng.choice(mods["sched"].BATCH_KINDS),
                FakeSet(bytes([rng.randrange(rng.choice((1, 3, 40)))]), rng.random() > 0.01),
                t_arrival=fake.t))
        sched.run_until_idle()
        now += 5.0
        steps.append([d.as_dict() for d in at.step(now=now)])
        evals.append({k: v.as_dict() for k, v in slo.last.items() if k != "route_fallback_rate"})
    policy = at.current_policy()
    policy.pop("updated_unix")
    return (steps, evals, policy, sched.close_margin_s, sched.router.small_batch_max,
            sched.policy.max_bucket, _exposition(reg))


@pytest.mark.parametrize("seed", [2, 9])
def test_autotuner_decisions_match_jax(seed, monkeypatch):
    jax_run = _autotune_run(JAX, monkeypatch, seed)
    port_run = _autotune_run(PORT, monkeypatch, seed)
    assert port_run == jax_run
    knobs = {d["knob"] for step in port_run[0] for d in step}
    assert {"close_margin", "router_cutoff", "bucket_menu", "warm_grid"} <= knobs
    assert pauto._m_bucket_shifts() == (8, 6, 4, 2, 0) and pauto._max_n_bucket() == 4096


def _apply(mods, monkeypatch, policy, env=None, check_env=True):
    if env is None:
        monkeypatch.delenv(mods["auto"].ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(mods["auto"].ENV_VAR, env)
    reg, _, sched = _stack(mods, monkeypatch, FakeTime())
    got = mods["auto"].apply_policy(policy, scheduler=sched, router=sched.router,
                                    batch_policy=sched.policy, check_env=check_env)
    return ([d.as_dict() for d in got], sched.close_margin_s, sched.default_latency_s,
            sched.router.small_batch_max, sched.router.table.snapshot(), sched.policy.max_bucket,
            mods["auto"].enabled_from_env(True))


POLICIES = [
    {"scheduler": {"close_margin_s": 0.08, "default_latency_s": 0.3},
     "router": {"small_batch_max": 4, "table": {"cpu:1": 0.004, "device:64": 0.03, "x": 1}},
     "max_bucket": 300},
    {"scheduler": {"close_margin_s": -5}, "router": {"small_batch_max": "8"}, "max_bucket": 1},
    None, "garbage", {},
]


@pytest.mark.parametrize("i", range(len(POLICIES)))
@pytest.mark.parametrize("env,check_env", [(None, True), ("0", True), ("0", False), ("1", True)])
def test_apply_policy_and_kill_switch_match_jax(i, env, check_env, monkeypatch):
    got = [_apply(mods, monkeypatch, POLICIES[i], env, check_env) for mods in (JAX, PORT)]
    assert got[1] == got[0]
    if i == 0:
        assert bool(got[1][0]) == (env != "0" or not check_env)


def test_kill_switch_gates_the_step(monkeypatch):
    monkeypatch.setenv(pauto.ENV_VAR, "off")
    reg = pm.Registry()
    misses = reg.counter("serving_scheduler_deadline_misses_total", "h")
    sched = types.SimpleNamespace(close_margin_s=0.05, default_latency_s=0.25, router=None)
    at = pauto.Autotuner(scheduler=sched, registry=reg)
    at.step(now=0.0)
    misses.inc(10)
    assert not at.enabled and at.step(now=10.0) == [] and sched.close_margin_s == 0.05


@pytest.mark.parametrize("policy", [
    None, "x", {}, {"warm_grid": []}, {"warm_grid": "bad"}, {"warm_grid": [[64, 1], [256, 4]]},
    {"warm_grid": [[1, 1]]}, {"warm_grid": [[64, 0]]}, {"warm_grid": [["a", 1]]},
    {"warm_grid": [[64]]}, {"warm_grid": [("128", 4.0)]}])
def test_tuned_shape_grid_matches_jax(policy):
    small = ((64, 1), (64, 4))
    assert pwarming.tuned_shape_grid(policy, small) == jwarming.tuned_shape_grid(policy, small)
    if pwarming.tuned_shape_grid(policy, small) == small:
        assert pwarming.tuned_shape_grid(policy) == pwarming.DEFAULT_SHAPE_GRID


def test_policy_manifest_reads_across_both_ways(tmp_path):
    pol = {"policy_version": 1, "max_bucket": 256, "warm_grid": [[64, 1], [256, 4]],
           "m_menu_shifts": [6, 0], "router": {"small_batch_max": 4, "table": {"cpu:1": 0.01}}}
    paot.save_policy(str(tmp_path / "p"), pol)
    assert jaot.load_policy(str(tmp_path / "p")) == pol
    jaot.save_policy(str(tmp_path / "j"), pol)
    assert paot.load_policy(str(tmp_path / "j")) == pol
    assert (tmp_path / "p" / paot.MANIFEST_NAME).read_bytes() == \
        (tmp_path / "j" / jaot.MANIFEST_NAME).read_bytes()
    # A manifest with bundle entries keeps them through a save by either.
    manifest = {"bundle_version": jaot.BUNDLE_VERSION, "jax_version": "x", "platform": "tpu",
                "entries": {"k": {"stages": ["s"]}}, "stages": {"s": {"file": "f"}}}
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "manifest.json").write_text(json.dumps(manifest))
    paot.save_policy(str(tmp_path / "b"), {"max_bucket": 64})
    jaot.save_policy(str(tmp_path / "b"), dict(jaot.load_policy(str(tmp_path / "b")), v=2))
    back = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert back["entries"] == manifest["entries"] and back["stages"] == manifest["stages"]
    assert paot.load_policy(str(tmp_path / "b")) == {"max_bucket": 64, "v": 2}
    assert paot.load_policy(str(tmp_path / "none")) is None
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.json").write_text("{not json")
    assert paot.load_policy(str(tmp_path / "bad")) is None is jaot.load_policy(str(tmp_path / "bad"))
    assert (paot.MANIFEST_NAME, paot.BUNDLE_VERSION) == (jaot.MANIFEST_NAME, jaot.BUNDLE_VERSION)


def test_autotuner_save_restores_in_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(pauto.ENV_VAR, raising=False)
    reg, _, sched = _stack(PORT, monkeypatch, FakeTime())
    sched.router.table.seed("device", 64, 0.03)
    at = pauto.Autotuner(scheduler=sched, batch_policy=sched.policy, registry=reg, enabled=True)
    saved = at.save(str(tmp_path))
    loaded = jaot.load_policy(str(tmp_path))
    assert loaded == saved and loaded["router"]["table"] == {"device:64": 0.03}
    assert jauto.policy_warm_grid(loaded) == pauto.policy_warm_grid(loaded) == []
    assert pauto.policy_m_menu(loaded, 4096) == jauto.policy_m_menu(loaded, 4096)


# --- provenance ------------------------------------------------------------------


def _delta(before):
    now = compile_events.counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _seconds_count(event):
    return compile_events._event_seconds().get_count(event)


def test_kernel_build_then_cache_hit(tmp_path, monkeypatch):
    """A stand-in nvcc (it writes the output file): a build records
    kernel_build with its seconds; a process finding the library built
    records kernel_cache_hit, once a source."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fp.cuh").write_text("// header\n")
    (csrc / "stand_in.cu").write_text("// source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    for attr, value in (("CSRC", csrc), ("BUILD_DIR", tmp_path / "build"),
                        ("SOURCES", ("stand_in",)), ("ENTRY_POINTS", {"stand_in": {}}),
                        ("BUILD_SECONDS", {}), ("_RESOLVED", set()), ("_LIBS", {})):
        monkeypatch.setattr(_build, attr, value)
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    before, secs = compile_events.counts(), _seconds_count("kernel_build")
    assert list(_build.build_all()) == ["stand_in"]
    assert _build.build_all() == {}                  # built: nothing to do, nothing recorded
    assert _delta(before) == {"kernel_build": 1}
    assert _seconds_count("kernel_build") == secs + 1
    monkeypatch.setattr(_build, "_RESOLVED", set())  # a fresh process
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace())
    _build.library("stand_in")
    _build.library("stand_in")
    assert _delta(before) == {"kernel_build": 1, "kernel_cache_hit": 1}


def test_native_build_then_cache_hit(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "stand_in.cpp").write_text('extern "C" int lh_stand_in() { return 7; }\n')
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "src"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cache", {})
    before, secs = compile_events.counts(), _seconds_count("native_build")
    assert native.load("stand_in").lh_stand_in() == 7
    assert native.load("stand_in").lh_stand_in() == 7     # this process's cache
    monkeypatch.setattr(native, "_cache", {})             # a fresh process
    assert native.load("stand_in").lh_stand_in() == 7
    assert _delta(before) == {"native_build": 1, "native_cache_hit": 1}
    assert _seconds_count("native_build") == secs + 1


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def __init__(self, keep_graph=False):
        self.instantiated = False

    def instantiate(self):
        self.instantiated = True


# What StaticGraph._capture asks of torch.cuda, on the CPU.
_FAKE_CUDA = types.SimpleNamespace(
    CUDAGraph=_FakeGraph, current_stream=lambda device=None: _FakeStream(),
    synchronize=lambda device=None: None, empty_cache=lambda: None,
    memory_reserved=lambda device=None: 0,
    stream=lambda *a, **k: contextlib.nullcontext(),
    graph=lambda *a, **k: contextlib.nullcontext())


def test_graph_capture_and_warm_path_are_recorded(monkeypatch):
    g = graphs.StaticGraph(lambda x: x + 1, [((3,), torch.int32)], "cpu", "stand-in m=1")
    monkeypatch.setattr(graphs, "torch", types.SimpleNamespace(cuda=_FAKE_CUDA))
    monkeypatch.setattr(graphs, "_capture_stream", lambda device: _FakeStream())
    monkeypatch.setattr(graphs, "graph_nodes", lambda graph: 7)
    before, secs = compile_events.counts(), _seconds_count("graph_capture")
    g._capture()
    assert g.graph.instantiated and g.stats["nodes"] == 7
    assert _delta(before) == {"graph_capture": 1}
    assert _seconds_count("graph_capture") == secs + 1

    class Core:
        lock = threading.RLock()
        graphs = ()

        def __call__(self, *args):
            return torch.tensor(True)

    monkeypatch.setattr(pwarming.backend, "graph_core", lambda *key: Core())
    pwarming.ShapeWarmer(shapes=((64, 1),), device="cpu").warm_one(64, 1)
    assert _delta(before) == {"graph_capture": 1, "warm_capture_path": 1}
    assert set(compile_events.counts()) == set(compile_events.EVENTS)


# --- report envelope and metric names --------------------------------------------


def test_report_envelope_matches_jax(monkeypatch):
    monkeypatch.setattr(jreport, "_env_facts", dict)     # it asks jax; env is not compared
    out = []
    for mod in (jreport, preport):
        r = mod.make("probe_x", {"n": 4}, trace_path=None)
        mod.finish(r, ok=False, results={"a": 1})
        out.append(r)
    assert list(out[1]) == list(out[0])
    assert {k: v for k, v in out[1].items() if k not in ("started_unix", "wall_seconds", "env")} \
        == {k: v for k, v in out[0].items() if k not in ("started_unix", "wall_seconds", "env")}
    assert out[1]["env"]["torch_version"] == torch.__version__
    lines = "noise\n" + json.dumps(out[0]) + "\n" + json.dumps(out[1]) + '\n{"schema": "other"}\n'
    assert preport.parse_lines(lines) == jreport.parse_lines(lines) == out
    buf = io.StringIO()
    assert preport.emit(out[1], buf) == buf.getvalue().strip()
    assert buf.getvalue().startswith('{"schema"')


def _lint_module():
    spec = importlib.util.spec_from_file_location("lint_metrics",
                                                  ROOT / "scripts" / "lint_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_metric_names_meet_the_lint_contract():
    """scripts/lint_metrics.py's rules over the port's files: snake_case,
    a unit suffix, registered once with help, bounded label names."""
    lint = _lint_module()
    registrations, seen, findings = {}, {}, []
    for path in sorted((ROOT / "lighthouse_tpu_torch").rglob("*.py")):
        for lineno, name, has_help, labels in lint.scan_file(str(path)):
            where = f"{path.relative_to(ROOT)}:{lineno}"
            seen.setdefault(name, where)
            if has_help:
                registrations.setdefault(name, []).append(where)
                findings += [f"{where}: {name} label {label}" for label in labels or ()
                             if label not in lint.ALLOWED_LABEL_NAMES]
    for name, where in seen.items():
        if not lint.SNAKE.match(name):
            findings.append(f"{where}: {name} not snake_case")
        if not name.endswith(lint.UNIT_SUFFIXES + lint.DIMENSIONLESS_SUFFIXES):
            findings.append(f"{where}: {name} has no unit suffix")
        if len(registrations.get(name, [])) != 1:
            findings.append(f"{name} registered with help at {registrations.get(name)}")
    assert findings == []
    assert {"engine_compile_events_total", "engine_compile_event_seconds", "slo_status",
            "slo_breaches_total", "serving_autotune_decisions_total",
            "engine_stage_seconds"} <= set(seen)
