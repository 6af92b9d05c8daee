"""One run of one benchmark cell: set-up, the measured window, the traced
span, the check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names a configuration (``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``); each per-layer metric is a reader in
``bench/metrics/<name>.py``. The system under test is the port's serving
engine (``repro_torch.serve.topo_service.TopoServingEngine``); the
benchmark hands it requests through ``submit()`` and reads its futures.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

SETUP_LIMIT_S = 240.0   # set-up past this (one build included) is a fault
TRACE_WARMUP_S = 0.5    # profiler on, records dropped (its first launches)
TRACE_SPAN_S = 2.0      # the profiled span
TRACE_TAIL_S = 1.0      # unprofiled, between the span and the close
TRACE_TRIES = 3         # spans made at most: one that recorded no kernel
                        # (CUPTI drops them, rarely) is made again
CHECK_TICKS = 2         # ticks the check follows after the window, at least
MAX_CHECK_TICKS = 64    # ... and until a lane has been harvested


class Refused(Exception):
    """The run cannot give a result (no card, a missing file): exit
    non-zero and print no result line."""


class WindowClosed(Exception):
    """Raised by the engine's step once the check's ticks are recorded:
    the tick loop fails every request still in flight, outside the window,
    and ends at once instead of serving them out."""


class TickCapture:
    """Put in the engine's step's place once the window has closed:
    records, for ``CHECK_TICKS`` ticks and on until a lane has been
    harvested, the request of each lane and the lanes' state before and
    after the tick; once ``finish`` is called, ends the tick loop at its
    next step (``WindowClosed``)."""

    PRE = ("x", "u", "hist", "it", "err")
    POST = PRE + ("compliance",)

    def __init__(self, engine):
        self.engine = engine
        self.step = engine.step
        self.ticks: List[Dict] = []
        self.uids_after = None
        self.recorded = threading.Event()
        self.closing = False

    def __call__(self, params, bp, load_vol, state):
        if self.closing:
            raise WindowClosed()
        if self.recorded.is_set():
            return self.step(params, bp, load_vol, state)
        shard = self.engine._shards[0]
        uids = np.array([-1 if a is None else a.req.uid
                         for a in shard.slot_adm[:state.x.shape[0]]])
        if self.ticks:
            last = self.ticks[-1]["uids"]
            harvest = bool((~np.isin(last[last >= 0], uids)).any())
            if (len(self.ticks) >= CHECK_TICKS and harvest
                    or len(self.ticks) >= MAX_CHECK_TICKS):
                self.uids_after = uids
                self.recorded.set()
                return self.step(params, bp, load_vol, state)
        pre = {n: getattr(state, n).clone() for n in self.PRE}
        new = self.step(params, bp, load_vol, state)
        self.ticks.append(dict(uids=uids, pre=pre, post={
            n: getattr(new, n).clone() for n in self.POST}))
        return new

    def install(self):
        """Take the step's place from the engine's next tick on."""
        self.hook = threading.excepthook

        def quiet(args):
            if not issubclass(args.exc_type, WindowClosed):
                self.hook(args)
        threading.excepthook = quiet
        self.engine.step = self

    def finish(self):
        """End the loop at its next step and wait for it; the loop's
        failure, if it was not this one's."""
        self.closing = True
        try:
            self.engine.shutdown(wait=True)
        finally:
            threading.excepthook = self.hook
        failure = self.engine._failure
        return None if isinstance(failure, WindowClosed) else failure


# ------------------------------------------------------------- the files

def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str):
    """(benchmark, cell, configuration file, traffic file) for ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json; have "
                      f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def load_reader(root: Path, name: str):
    """The per-layer metric's reader module ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def sleep_until(t: float, engine, series: List[int]):
    """Sleep until monotonic time ``t``, noting the engine's tick count
    every second."""
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(1.0, left))
        series.append(engine.total_steps)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# ---------------------------------------------------------------- power

class PowerSampler:
    """``nvidia-smi --query-gpu=power.draw`` every 500 ms in a child
    process, each line stamped on the host's monotonic clock."""

    def __init__(self, index: int):
        self.samples: List[tuple] = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=power.draw",
                 "--format=csv,noheader,nounits", "-lms", "500",
                 "-i", str(index)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append((time.monotonic(), float(line)))
            except ValueError:
                continue

    def stop(self):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)

    def joules(self, t0: float, t1: float) -> Optional[float]:
        """Energy over [t0, t1]: the samples integrated by trapezoids,
        held flat past the first and last; None with under 5 samples
        inside."""
        s = [(t, w) for t, w in self.samples if math.isfinite(w)]
        if sum(t0 <= t <= t1 for t, _ in s) < 5:
            return None
        ts = np.array([t for t, _ in s])
        ws = np.array([w for _, w in s])
        grid = np.concatenate([[t0], ts[(ts > t0) & (ts < t1)], [t1]])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(np.interp(grid, ts, ws), grid))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


# ---------------------------------------------------------- the clients

@dataclasses.dataclass
class Rec:
    """One request as its client saw it."""
    j: int
    case: int
    n_iter: int
    req: object
    t_submit: float
    t_done: float = math.nan
    fut: object = None


class ClosedLoop:
    """``n_clients`` clients, each submitting its next request when its
    last one resolves. Client k joins at engine tick
    ``k * join_ticks // n_clients``. One driver thread submits, every
    ``POLL_S``: the engine admits at tick boundaries, far apart, so the
    clients returned since the last pass lose no admission. The futures'
    callbacks, which run on the tick thread, only stamp the time and hand
    the client back."""

    POLL_S = 0.02

    def __init__(self, engine, make_request, counts, order, n_clients,
                 join_ticks):
        self.engine = engine
        self.make_request = make_request
        self.counts, self.order = counts, order
        self.n_clients, self.join_ticks = n_clients, join_ticks
        self.returned: collections.deque = collections.deque()
        self.records: List[Rec] = []
        self.joined = 0
        self.done_n = 0
        self.closing = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._drive, name="clients",
                                       daemon=True)

    def _done(self, rec: Rec):
        rec.t_done = time.monotonic()
        self.done_n += 1                 # the tick thread's alone
        self.returned.append(rec)        # deque.append is atomic

    def _submit(self):
        j = len(self.records)
        n = len(self.counts)
        case = int(self.order[j % len(self.order)])
        rec = Rec(j=j, case=case, n_iter=int(self.counts[j % n]),
                  req=None, t_submit=0.0)
        rec.req = self.make_request(j, case, rec.n_iter)
        self.records.append(rec)
        rec.t_submit = time.monotonic()
        rec.fut = self.engine.submit(rec.req)
        rec.fut.add_done_callback(lambda _f, r=rec: self._done(r))

    def _drive(self):
        try:
            while not self.closing.wait(self.POLL_S):
                back = 0
                while self.returned:
                    self.returned.popleft()
                    back += 1
                if self.joined < self.n_clients:
                    due = min(self.n_clients, (self.engine.total_steps + 1)
                              * self.n_clients // self.join_ticks)
                    back += max(0, due - self.joined)
                    self.joined = max(self.joined, due)
                for _ in range(back):
                    self._submit()
        except BaseException as exc:     # reported by the harness
            self.error = exc

    def start(self):
        self.thread.start()

    def close(self):
        self.closing.set()
        self.thread.join()


# ---------------------------------------------------------- the profile

def profile_span(seconds: float, warmup_s: float, snapshot, device: str):
    """Profile the device for ``seconds`` of steady serving, after
    ``warmup_s`` in which the profiler runs and its records are dropped
    (its first launches stall the host); the engine's lane counters are
    read just before and just after the recorded part. CUDA activity
    only: the kernels and the runtime calls that launch and copy, not
    every operator of the host, whose recording would slow the
    host-paced tick it measures (on the CPU, which a test runs, its
    operators)."""
    import torch
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CUDA if device == "cuda" else act.CPU],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    time.sleep(warmup_s)
    before = snapshot()
    prof.step()
    t_a = time.monotonic()
    time.sleep(seconds)
    t_b = time.monotonic()
    prof.stop()
    after = snapshot()
    return prof, t_b - t_a, before, after


def trace_events(prof):
    """(device events, host events) as (name, start s, end s) from the
    profiler's raw records, timed from the first record."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e9
        b = a + e.duration_ns() / 1e9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), a, b))
        else:
            host.append((e.name(), a, b))
    t0 = min([a for _, a, _ in dev + host], default=0.0)
    dev = [(n, a - t0, b - t0) for n, a, b in dev]
    host = [(n, a - t0, b - t0) for n, a, b in host]
    return dev, host


def busy_intervals(dev, window_s: float):
    """The union of device activity intervals inside [0, window_s]."""
    spans = sorted((max(a, 0.0), min(b, window_s)) for _, a, b in dev
                   if b > 0 and a < window_s)
    merged: List[list] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def breakdown(dev, host, merged, window_s: float):
    by_name: Dict[str, float] = collections.Counter()
    for n, a, b in dev:
        by_name[n[:160]] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [0.0] + [x for ab in merged for x in ab] + [window_s]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            gaps.append((a, b))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out = []
    for a, b in gaps:
        best, label = 0.0, "host: no recorded call"
        for n, ha, hb in host:
            ov = min(b, hb) - max(a, ha)
            if ov > best and not n.startswith("ProfilerStep"):
                best, label = ov, f"host: {n[:120]}"
        out.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


# -------------------------------------------------------------- the run

def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root: Path, device: str = "cuda", t_start: Optional[float] = None,
        plant=None, control: bool = False, log=print) -> Dict:
    """One run of the cell; returns the result object. ``device="cpu"``
    and ``plant`` (a callable given the engine before it starts, which
    may break it) are for the tests, and ``control`` (the check judges
    the reference at TF32 in the program's place) for them and
    ``bench.control``: a benchmark run is made with none of them."""
    t_start = time.monotonic() if t_start is None else t_start
    bench, cell, config, traffic = load_cell(root, cell_name)
    phases: Dict[str, float] = {}
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"needs {cell['chips']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs.cronet import CRONetConfig, get_cronet_config
    from repro_torch.fea import fea2d
    from repro_torch.serve.topo_service import TopoRequest, TopoServingEngine

    from bench import check, loads, reference

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["config"].items()}
    cfg = CRONetConfig(**fields)
    if "size" in config and cfg != get_cronet_config(config["size"]):
        raise Refused(f"{cell['config']}: the file's sizes differ from "
                      f"get_cronet_config({config['size']!r})")
    dev = torch.device(device)
    eng_spec = traffic["engine"]
    slots = int(traffic["slots"])

    # inputs from the seed: weights on the device, the load-case pool
    weights = reference.make_weights(int(config["weights_seed"]), dev)
    pool = loads.load_pool(traffic, cfg.nelx, cfg.nely, seed)
    counts = loads.iteration_counts(traffic, seed)
    order = loads.case_order(traffic, seed)
    tmpl = fea2d.mbb_problem(cfg.nelx, cfg.nely)
    free = torch.from_numpy(pool.free[0].copy())        # the same supports
    fixed_x = torch.from_numpy(pool.fixed_x[0].copy())  # for every case
    problems = [fea2d.Problem(
        nelx=cfg.nelx, nely=cfg.nely, edof=tmpl.edof, free_mask=free,
        f=torch.from_numpy(pool.f[i].copy()), KE=tmpl.KE,
        volfrac=float(pool.volfrac[i]), fixed_x_mask=fixed_x)
        for i in range(len(pool.f))]

    def make_request(j, case, n_iter):
        return TopoRequest(uid=j, problem=problems[case], n_iter=n_iter)

    if trace and device == "cuda":     # CUPTI's start-up, outside the window
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()

    phases["inputs"] = time.monotonic() - t_start
    if device == "cuda":     # the program's nvcc libraries, once a checkout
        from repro_torch.kernels import build_all
        t_build = time.monotonic()
        build_all()
        phases["build"] = time.monotonic() - t_build
    engine = TopoServingEngine(
        cfg, weights, float(eng_spec["u_scale"]), slots=slots,
        precision=config["precision"],
        error_threshold=float(eng_spec["error_threshold"]),
        verify_every=int(eng_spec["verify_every"]),
        rmin=float(eng_spec["rmin"]), shards=int(eng_spec["shards"]),
        device=device)
    if plant is not None:
        plant(engine)
    n_clients = slots + int(traffic["spare_clients"])
    loop = ClosedLoop(engine, make_request, counts, order, n_clients,
                      int(traffic["join_over_ticks"]))
    power = (PowerSampler(torch.cuda.current_device())
             if device == "cuda" else None)
    loop.start()
    phases["engine"] = time.monotonic() - t_start

    # warm-up: every client joined, one generation of lanes completed
    limit = t_start + SETUP_LIMIT_S
    while not (loop.joined == n_clients and loop.done_n >= slots):
        if "first_tick" not in phases and engine.total_steps > 0:
            phases["first_tick"] = time.monotonic() - t_start
        if loop.error is not None or engine._failure is not None:
            raise RuntimeError("serving failed during warm-up") from (
                loop.error or engine._failure)
        if time.monotonic() > limit:
            raise RuntimeError(f"warm-up not done after "
                               f"{SETUP_LIMIT_S} s: "
                               f"{loop.joined} clients, {loop.done_n} done")
        time.sleep(0.05)
    t0 = time.monotonic()
    setup_s = t0 - t_start
    steps0 = engine.total_steps
    phases["warm_ticks"] = steps0
    ticks_seen: List[int] = [steps0]

    if trace:
        t_prof = (t0 + seconds - TRACE_TAIL_S
                  - TRACE_TRIES * (TRACE_SPAN_S + TRACE_WARMUP_S))
        sleep_until(t_prof, engine, ticks_seen)
        t_a = time.monotonic()
        steps_a = engine.total_steps

        def snapshot():
            sh = engine._shards[0]
            st = sh.state
            adm = list(sh.slot_adm)
            steps = engine.total_steps
            it = st.it.cpu().numpy()
            cg = st.cg_iters.cpu().numpy()
            occ = np.array([a is not None for a in adm[:len(it)]])
            return dict(t=time.monotonic(), steps=steps,
                        cg=int(cg.astype(np.int64).sum()),
                        occupied=int(occ.sum()),
                        warm=int((occ & (it >= cfg.hist_len)).sum()))

        for _ in range(TRACE_TRIES):
            prof, window_s, before, after = profile_span(
                TRACE_SPAN_S, TRACE_WARMUP_S, snapshot, device)
            dev_ev, host_ev = trace_events(prof)
            del prof
            if device != "cuda" or any(
                    not n.startswith(("Memcpy", "Memset"))
                    for n, _, _ in dev_ev):
                break
            log("the profiled span recorded no kernel: profiling again")
    t1 = t0 + seconds
    sleep_until(t1, engine, ticks_seen)
    steps1 = engine.total_steps
    mem_peak = (int(torch.cuda.max_memory_allocated(dev))
                if device == "cuda" else 0)
    t_close = time.monotonic()
    capture = TickCapture(engine)    # the clients still sending
    capture.install()
    capture.recorded.wait(SETUP_LIMIT_S)
    loop.close()
    failure = loop.error or capture.finish()
    if power is not None:
        power.stop()
    phases["stop"] = time.monotonic() - t_close

    in_window = [r for r in loop.records if t0 <= r.t_done <= t1]
    ok = [r for r in in_window if r.fut.exception() is None
          and r.req.density is not None
          and bool(np.isfinite(r.req.density).all())
          and math.isfinite(r.req.compliance)]
    result: Dict = {"correct": False, "attempted": len(in_window),
                    "failed": len(in_window) - len(ok)}
    metrics: Dict[str, Dict] = {}
    if not trace:
        lat = [r.t_done - r.t_submit for r in in_window]
        values = {"designs_per_s": len(ok) / seconds,
                  "p95_latency_s": percentile(lat, 95) if lat else None,
                  "setup_s": setup_s}
        joules = power.joules(t0, t1) if power is not None else None
        if joules:
            values["designs_per_kj"] = len(ok) / (joules / 1e3)
        for m in bench["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        tick_ticks = steps_a - steps0
        waits = [r.req.queue_wait_s for r in loop.records
                 if r.req.admitted_t is not None
                 and t0 <= r.req.admitted_t < t_a]
        t_read = time.monotonic()
        merged = busy_intervals(dev_ev, window_s)
        busy_s = sum(b - a for a, b in merged)
        harvested = [r for r in loop.records
                     if before["t"] <= r.t_done <= after["t"]]
        reading = dict(
            cfg=cfg, slots=slots, queue_waits=waits,
            unprofiled_s=t_a - t0, unprofiled_ticks=tick_ticks,
            window_s=window_s, busy_s=busy_s, device_events=dev_ev,
            span_ticks=after["steps"] - before["steps"],
            span_cg_iters=(after["cg"] - before["cg"]
                           + sum(r.req.cg_iters for r in harvested)),
            mean_occupied=(before["occupied"] + after["occupied"]) / 2,
            mean_warm=(before["warm"] + after["warm"]) / 2)
        for m in bench["per_layer"]:
            value = load_reader(root, m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = breakdown(dev_ev, host_ev, merged, window_s)
        phases["trace_read"] = time.monotonic() - t_read
        if reading["span_ticks"] > 0 and tick_ticks > 0:
            log(f"ms a tick: profiled span "
                f"{1e3 * window_s / reading['span_ticks']!r}, unprofiled "
                f"{1e3 * reading['unprofiled_s'] / tick_ticks!r}")
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if device == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]), "memory_peak_bytes": mem_peak}
    if trace:
        result["device"].update(busy_s=busy_s, window_s=window_s)
    if device == "cuda":
        result["device"]["power_limit"] = power_limit()
        torch.cuda.empty_cache()     # the engine dropped its device state

    # the check, once the program's state is freed
    t_check = time.monotonic()
    numbers = check.compare(capture, loop.records, pool, config, eng_spec,
                            dev, control=control)
    if control:      # the program's readings on the same ticks, beside
        result["program_check"] = check.compare(
            capture, loop.records, pool, config, eng_spec, dev)
        result["program_check"].pop("_pass")
    phases["check"] = time.monotonic() - t_check
    result["correct"] = bool(numbers.pop("_pass")) and failure is None
    if failure is not None:
        log(f"serving failed: {failure!r}")
    result["check"] = numbers
    log("phases " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    log("ticks a second " + json.dumps(np.diff(ticks_seen).tolist()))
    log(f"window {seconds} s, ticks {steps1 - steps0}, attempted "
        f"{result['attempted']}, failed {result['failed']}, setup "
        f"{setup_s:.2f} s")
    for k, v in numbers.items():
        if isinstance(v, dict):
            log(f"check {k} {v['value']!r} limit {v['limit']!r}")
        else:
            log(f"check {k} {v!r}")
    return result
