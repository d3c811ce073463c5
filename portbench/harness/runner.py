"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the per-layer metrics of a traced run. The cell's
traffic mix names its kind: "frames" (back-to-back renders through
``render_linear``), "train_steps" (back-to-back steps of the train step)
or "train_steps_sharded" (the train step over a mesh of ranks, one process
a card: ``harness/ranks.py``).

``run`` returns the result's fields; ``portbench/run.py`` checks the cards
first and prints the line. The CPU tests call ``run`` with device="cpu" on
a shrunken cell.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field

import torch

from . import check, inputs, manifest, port, stats
from . import trace as trace_mod
from ..reference import rng

WARM_FOLD = 0xFFFFFFFE        # the key of the warm-up frame: never a unit's
REF_DTYPE = torch.float64
STOP, STEP, TRACED = 0, 1, 2  # what the window does next


@dataclass
class Run:
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    metrics: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    traces: list = field(default_factory=list)
    traced_keys: list = field(default_factory=list)   # [2] key of each unit
    phases: dict = field(default_factory=dict)        # seconds by phase
    scene_inputs: dict | None = None
    fault: str | None = None                          # planted by each rank
    rank_traces: list = field(default_factory=list)   # sharded: by rank
    _wavefronts: dict = field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def busy_s(self) -> float:
        """Device seconds busy in the traced units, averaged over the
        cards of a sharded run."""
        if self.rank_traces:
            return sum(t.busy_s for t in self.rank_traces) / \
                len(self.rank_traces)
        return self.trace_data.busy_s

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # --- what the per-layer metrics read -------------------------------
    @property
    def trace_data(self):
        return self.traces[0] if self.traces else None

    def wavefronts(self, stride: int) -> list:
        """The reference's bounce wavefronts of the traced units, traced on
        every stride-th pixel: a list (one entry a bounce a unit) of
        {"o", "d", "t_sphere", "t_hit"}."""
        if stride not in self._wavefronts:
            r = self.cfg["render"]
            n = int(r["width"]) * int(r["height"])
            plain = manifest.reference(self.cfg)
            sc = plain.make_scene(self.scene_inputs, REF_DTYPE, self.device)
            cam = plain.make_camera(self.cfg["camera"],
                                    r["width"] / r["height"], REF_DTYPE,
                                    self.device)
            rec: list = []
            pix = torch.arange(0, n, stride, device=self.device)
            with torch.no_grad():
                for key in self.traced_keys:
                    plain.render_pixels(sc, cam, r, key.to(self.device), pix,
                                        REF_DTYPE, record=rec)
            self._wavefronts[stride] = rec
        return self._wavefronts[stride]

    def roofline_pct(self, layer: str):
        """100 x the seconds the layer's work in the traced units needs at
        the card's peaks, by the frozen rule roofline/<layer>.py, over the
        device time of the rule's kernels in the trace; None without a
        trace or where it holds none of them."""
        tr = self.trace_data
        if tr is None:
            return None
        rule = manifest.roofline_rule(layer)
        kernel_s = tr.kernel_seconds(trace_mod.names(rule.KERNELS))
        if kernel_s <= 0:
            return None
        waves = self.wavefronts(rule.STRIDE)
        return 100.0 * rule.bound_s(waves, self.scene_inputs,
                                    rule.STRIDE) / kernel_s


def window_rule(trace: bool, traffic: dict, seconds: float, units: int):
    """The window's rule, word(k, elapsed, traced): STOP once the window
    has closed or the keys have run out, TRACED for the traced stretch of
    a --trace 1 run once the window is trace_at through, else STEP."""
    at = float(traffic["trace_at"]) * seconds

    def word(k: int, elapsed: float, traced: bool) -> int:
        if k >= units or elapsed >= seconds:
            return STOP
        if trace and not traced and elapsed >= at:
            return TRACED
        return STEP

    return word


def _stretch(word: int, traffic: dict, traces: list):
    """(context, units) of the next stretch: the profiler over the
    traffic's trace_units, or one untraced unit."""
    if word == TRACED:
        n = int(traffic["trace_units"])
        return trace_mod.traced(n, traces), n
    return contextlib.nullcontext(), 1


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- frames
def frames(run: Run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    r = cfg["render"]
    w, h, spp = int(r["width"]), int(r["height"]), int(r["spp"])
    run.scene_inputs = inputs.scene_inputs(cfg["scene"])
    scene = port.build_scene(run.scene_inputs, cfg, dev)
    cam = port.build_camera(cfg, dev)
    rcfg = port.render_config(cfg)
    render = port.render_linear()
    keys = inputs.unit_keys(run.seed, int(tr["max_units"])).to(dev)
    pix = torch.as_tensor(inputs.sample_pixels(run.seed, w * h,
                                               int(cfg["check"]["pixels"])),
                          device=dev)
    warm = rng.fold_in(inputs.base_key(run.seed), WARM_FOLD).to(dev)
    for _ in range(int(tr.get("warmup_units", 1))):
        render(scene, cam, rcfg, warm)
        run.sync()
    run.metrics["setup_s"] = time.perf_counter() - run.t_start

    if run.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lat, ends, got = [], [], []
    img = None
    rule = window_rule(run.trace, tr, run.seconds, keys.shape[0])
    t0 = time.perf_counter()
    k = 0
    while True:
        word = rule(k, time.perf_counter() - t0, bool(run.traced_keys))
        if word == STOP:
            break
        cm, n = _stretch(word, tr, run.traces)
        with cm:
            for _ in range(n):
                s = time.perf_counter()
                img = render(scene, cam, rcfg, keys[k])
                got.append(img.reshape(-1, 3).index_select(0, pix).cpu())
                run.sync()
                e = time.perf_counter()
                lat.append(e - s)
                ends.append(e)
                k += 1
        if word == TRACED:
            run.traced_keys = [keys[i].cpu() for i in range(k - n, k)]
    if run.cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    done = [i for i, e in enumerate(ends) if e - t0 <= run.seconds]
    run.attempted = len(lat)
    if done:
        last = ends[done[-1]]
        rate = stats.window_rate(len(done) * w * h * spp, t0, last)
        run.metrics["frame_msamples_s"] = rate / 1e6
        run.metrics["frame_p95_ms"] = \
            stats.percentile([lat[i] for i in done], 95) * 1e3
    run.metrics["peak_mem_gib"] = run.peak_bytes / 2 ** 30
    run.phases["window"] = time.perf_counter() - t0
    del scene, cam, img
    _free()
    t_check = time.perf_counter()

    # The check: sampled pixels of sampled frames against the reference.
    ck = cfg["check"]
    picks = inputs.sample_units(run.seed, len(done), int(ck["frames"]))
    if not picks:
        run.checks = check.judge({}, ck["limits"])
        run.failed = run.attempted
        return
    plain = manifest.reference(cfg)
    sc = plain.make_scene(run.scene_inputs, REF_DTYPE, dev)
    rcam = plain.make_camera(cfg["camera"], w / h, REF_DTYPE, dev)
    p = pix.shape[0]
    ray_keys = keys[picks].repeat_interleave(p, dim=0)
    ray_pix = pix.repeat(len(picks))
    with torch.no_grad():
        ref = plain.render_pixels(sc, rcam, r, ray_keys, ray_pix,
                                  REF_DTYPE).reshape(len(picks), p, 3)
    mine = torch.stack([got[i] for i in picks]).to(dev)
    del sc
    per_frame = [check.pixel_mismatch_share(mine[i], ref[i],
                                            float(ck["atol"]),
                                            float(ck["rtol"]))
                 for i in range(len(picks))]
    values = {"px_mismatch_share": check.pixel_mismatch_share(
        mine, ref, float(ck["atol"]), float(ck["rtol"]))}
    run.checks = check.judge(values, ck["limits"])
    limit = ck["limits"]["px_mismatch_share"]
    run.failed = sum(1 for v in per_frame if not v <= limit)
    run.phases["check"] = time.perf_counter() - t_check


# ----------------------------------------------------------- train steps
def _adam_grads(state, leaves_fn) -> dict:
    """The gradient each leaf's Adam got at its first step, worked out from
    its state: exp_avg / (1 - beta1)."""
    opt = state.opt_state
    out = {}
    for path, p in leaves_fn(state.params):
        group = next(g for g in opt.param_groups
                     if any(q is p for q in g["params"]))
        out[path] = opt.state[p]["exp_avg"].detach().clone() / \
            (1.0 - group["betas"][0])
    return out


def first_steps(cfg: dict, seed: int, dev, count: int, max_units: int,
                mesh=None):
    """Set-up of a train cell: the target and the port's train step from
    the starting point, driven through its first `count` steps with the
    window's own call; with a mesh, the target's render and every step are
    sharded over its ranks. Returns the objects the window goes on with
    (the state, the step and its leaves function, the target, the keys) and
    the readings the check compares (each step's loss, the first gradient
    as Adam got it, the change of every leaf after the steps)."""
    t = cfg["train"]
    true_inputs = inputs.scene_inputs(cfg["scene"])
    start_inputs = inputs.scene_inputs(cfg["scene"], t.get("start"))
    tkey = inputs.target_key(seed).to(dev)
    target = port.mean_image(port.build_scene(true_inputs, cfg, dev),
                             port.build_camera(cfg, dev), cfg, tkey, mesh)
    scene = port.build_scene(start_inputs, cfg, dev)
    cam = port.build_camera(cfg, dev, translate=t["pose_error"])
    init, step, leaves_fn = port.train_step(scene, cam, cfg, mesh)
    state = init()
    first = {p: v.detach().clone() for p, v in leaves_fn(state.params)}
    keys = inputs.unit_keys(seed, max_units).to(dev)
    losses, grad1 = [], None
    for k in range(count):
        state, loss = step(state, target, keys[k])
        losses.append(float(loss))
        if k == 0:
            grad1 = _adam_grads(state, leaves_fn)
    after = {p: v.detach().clone() for p, v in leaves_fn(state.params)}
    return {"state": state, "step": step, "leaves": leaves_fn,
            "target": target, "keys": keys, "tkey": tkey,
            "true_inputs": true_inputs, "start_inputs": start_inputs,
            "losses": losses, "grad": grad1,
            "change": {p: after[p] - first[p] for p in after}}


def reference_steps(fs: dict, cfg: dict, dev, count: int,
                    dtype=REF_DTYPE) -> dict:
    """The configuration's reference following the first `count` steps of
    first_steps's `fs` from the same start, in `dtype`."""
    return manifest.reference(cfg).steps(
        fs["true_inputs"], fs["start_inputs"], cfg, fs["keys"][:count].cpu(),
        fs["tkey"].cpu(), dtype, dev,
        block=int(cfg["check"].get("block", 1 << 17)), count=count)


@dataclass
class Window:
    """What a train cell's window leaves: its start, each step's latency
    and end, the keys of the traced steps, whether the last loss was
    finite."""

    t0: float
    lat: list
    ends: list
    traced_keys: list
    finite: bool

    def metrics(self, seconds: float) -> dict:
        """view_step_s: the window's start to the last step completed in
        it, over those steps; nothing where none completed."""
        done = [i for i, e in enumerate(self.ends) if e - self.t0 <= seconds]
        if not done:
            return {}
        return {"view_step_s": (self.ends[done[-1]] - self.t0) / len(done)}


def step_window(fs: dict, k: int, word, sync, traffic: dict,
                traces: list) -> Window:
    """The measured window of a train cell: the step of first_steps's
    `fs` driven from key k on, back to back, each step ending in sync(),
    while word(k, elapsed, traced) says STEP or TRACED; the traced stretch
    runs under the profiler, its Trace appended to traces."""
    state, step, target, keys = fs["state"], fs["step"], fs["target"], \
        fs["keys"]
    loss = torch.tensor(fs["losses"][-1])
    lat, ends, traced_keys = [], [], []
    t0 = time.perf_counter()
    while True:
        w = word(k, time.perf_counter() - t0, bool(traced_keys))
        if w == STOP:
            break
        cm, n = _stretch(w, traffic, traces)
        with cm:
            for _ in range(n):
                s = time.perf_counter()
                state, loss = step(state, target, keys[k])
                sync()
                e = time.perf_counter()
                lat.append(e - s)
                ends.append(e)
                k += 1
        if w == TRACED:
            traced_keys = [keys[i].cpu() for i in range(k - n, k)]
    return Window(t0, lat, ends, traced_keys, math.isfinite(float(loss)))


KEPT = ("losses", "grad", "change", "keys", "tkey", "true_inputs",
        "start_inputs")


def judge_steps(kept: dict, cfg: dict, dev, count: int, finite: bool,
                values: dict | None = None, limits: dict | None = None):
    """(checks, failed) of a train cell: the reference follows the port's
    first `count` steps from the same start (``compare_steps``), judged by
    the configuration's limits, with a traffic's own values and limits
    beside them; a loss that ended not finite fails one more."""
    ref = reference_steps(kept, cfg, dev, count)
    checks = check.judge({**compare_steps(kept, ref), **(values or {})},
                         {**cfg["check"]["limits"], **(limits or {})})
    failed = sum(1 for v in checks.values() if not v["ok"]) + \
        (0 if finite else 1)
    return checks, failed


def train_steps(run: Run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    n_check = int(tr["setup_steps"])
    fs = first_steps(cfg, run.seed, dev, n_check, int(tr["max_units"]))
    run.scene_inputs = fs["start_inputs"]
    run.sync()
    run.metrics["setup_s"] = time.perf_counter() - run.t_start

    if run.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rule = window_rule(run.trace, tr, run.seconds, fs["keys"].shape[0])
    win = step_window(fs, n_check, rule, run.sync, tr, run.traces)
    if run.cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    run.traced_keys = win.traced_keys
    run.attempted = len(win.lat)
    run.metrics.update(win.metrics(run.seconds))
    run.metrics["peak_mem_gib"] = run.peak_bytes / 2 ** 30
    run.phases["window"] = time.perf_counter() - win.t0
    kept = {k: fs[k] for k in KEPT}
    del fs
    _free()
    t_check = time.perf_counter()
    run.checks, run.failed = judge_steps(kept, cfg, dev, n_check, win.finite)
    run.phases["check"] = time.perf_counter() - t_check


def compare_steps(got: dict, ref: dict) -> dict:
    """The compared numbers of a train cell, from the port's first steps
    ({"losses", "grad", "change"}) and the reference's (its ``steps``):
    the first step's loss, which both sides compute from the same
    parameters, and the worst step's, which carries the later steps' noise
    (Adam moves a leaf of small gradient by its rate whatever the
    gradient's size); the first gradient's gap by the worst leaf
    ("grad_gap"), for the median leaf ("grad_gap_median") and for each
    leaf alone ("grad_gap[<leaf>]", such as "grad_gap[camera/translate]");
    the change's by the worst leaf that moves. A configuration's limits
    name the numbers that are compared."""
    keep = check.moving_leaves(ref["grad"])
    med = [check.median_leaf(ref["grad"])]
    out = {"loss1_gap": check.loss_gap(got["losses"][:1], ref["losses"][:1]),
           "loss_gap": check.loss_gap(got["losses"], ref["losses"]),
           "grad_gap": check.leaf_gap(got["grad"], ref["grad"]),
           "grad_gap_median": check.leaf_gap(got["grad"], ref["grad"], med)}
    for leaf in ref["grad"]:
        out[f"grad_gap[{leaf}]"] = check.leaf_gap(got["grad"], ref["grad"],
                                                  [leaf])
    out["change_gap"] = check.leaf_gap(got["change"], ref["change"], keep)
    return out


def train_steps_sharded(run: Run) -> None:
    """Train steps sharded over a mesh of ranks, one process a card
    (``harness/ranks.py``)."""
    from . import ranks

    ranks.drive(run)


DRIVERS = {"frames": frames, "train_steps": train_steps,
           "train_steps_sharded": train_steps_sharded}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides: dict | None = None,
        fault: str | None = None) -> dict:
    """One run of the cell; the result line's fields but "device"'s card
    name, and the Run for what else a caller reads. fault: the name of a
    fault of ``portbench/faults.py`` that each rank of a sharded cell
    plants in its own process (the CPU tests; a cell that runs in this
    process is broken by planting the fault here instead)."""
    bench = manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = manifest.config(bench, cell["config"], overrides)
    traffic = manifest.traffic(cell["traffic"])
    r = Run(cfg, traffic, int(seed), float(seconds), bool(trace),
            torch.device(device), t_start, fault=fault)
    DRIVERS[traffic["kind"]](r)
    t_read = time.perf_counter()
    if trace:
        metrics = {}
        for m in manifest.layer_metrics(bench, cell_name):
            value = manifest.metric_module(m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": r.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in manifest.e2e_metrics(bench, cell_name)
                   if m["name"] in r.metrics}
    r.phases["layer_metrics"] = time.perf_counter() - t_read
    correct = bool(r.checks) and all(v["ok"] for v in r.checks.values()) \
        and r.failed == 0 and r.attempted > 0
    return {"correct": correct, "attempted": r.attempted, "failed": r.failed,
            "metrics": metrics, "run": r}
