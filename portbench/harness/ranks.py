"""The "train_steps_sharded" kind: back-to-back train steps of the port,
each sharded over an (sp, px) mesh of ranks, one process a card.

``drive`` runs in the process that prints the result. It builds the
port's kernels, starts the traffic's ``ranks`` processes and waits for
them. Each rank (``_rank_main``) joins a process group (NCCL on
cuda:rank, gloo on the CPU) through a file store in a fresh temporary
directory, builds the scene and camera from the benchmark's inputs as the
one-card train cells do, and drives the port's train step with
``mesh=make_mesh(sp, px)``: the target and the set-up steps, then the
window.

Rank 0 owns the clock, the window, the trace and the check. Before each
step it tells every rank, over a gloo group off the card's stream, whether
to stop, to run the step, or to run it traced. The flag travels as an
all-reduce, so a step starts only once the step before has synchronized
on every rank, and no rank decides on a clock of its own. The window and
the check are the one-card train cells' (``runner.step_window``,
``runner.judge_steps``); only the word differs. Every rank traces a
traced step. After the window every rank hands rank 0 its peak memory,
the device part of its trace (``Run.rank_traces``, for the busy seconds
and the collectives' metrics), its parameters after the set-up steps and
the JAX modules it loaded, and all leave the group. Rank 0 then runs the
check on its card, looks at its own modules once more, and sends the
run's fields back through a pipe: the configuration's own numbers, the
reference following the first steps as in the one-card cells, and the
traffic's, which look at every rank (``rank_param_gap``: each rank holds
rank 0's parameters after the set-up steps; ``target_mismatch_share``:
the sampled pixels of the sharded target against the reference's).

A rank that raises or dies ends the run: ``drive`` kills the other ranks,
joins them and raises. A rank that hangs makes its peers' collectives
fail after ``port.GROUP_TIMEOUT_S``, and they end the same way. Each rank
also dies with the process that started it (PR_SET_PDEATHSIG), so none
outlives the run.

A step is paced by its ranks' host threads, which launch its kernels, and
the slowest rank sets every step. So each rank on the cards keeps to cores
of its own (``rank_cores``: those nearest its card, split among the ranks
that share them), where no other rank's threads run and from which its
own do not move.

``setup_s`` runs from the starting process's clock (``time.perf_counter``
is the system's monotonic clock, one for every process) to the first
timed step on rank 0.
"""

from __future__ import annotations

import ctypes
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import signal
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from . import check, env, inputs, manifest, port, runner

# The longest the starting process waits for ranks that neither end nor
# fail: past a first run's build and compile, never reached otherwise.
WAIT_S = 1100


def drive(run) -> None:
    """Run the sharded cell's ranks and set the run's fields from rank 0's
    readings; raises when a rank fails."""
    tr = run.traffic
    ranks = int(tr["ranks"])
    sp, px = int(tr["mesh"]["sp"]), int(tr["mesh"]["px"])
    if sp * px != ranks:
        raise ValueError(f"mesh sp*px = {sp}*{px} is not the traffic's "
                         f"{ranks} ranks")
    if run.cuda:
        if torch.cuda.device_count() < ranks:
            raise RuntimeError(f"{ranks} ranks need {ranks} CUDA cards; "
                               f"{torch.cuda.device_count()} here")
        port.build_kernels()
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    recv, send = ctx.Pipe(duplex=False)
    args = {"cfg": run.cfg, "traffic": tr, "seed": run.seed,
            "seconds": run.seconds, "trace": run.trace,
            "device": run.device.type, "t_start": run.t_start,
            "t_spawn": time.perf_counter(), "fault": run.fault,
            "store": os.path.join(tmp, "store"), "ranks": ranks}
    procs = [ctx.Process(target=_rank_main,
                         args=(r, args, send if r == 0 else None),
                         name=f"portbench-rank{r}", daemon=True)
             for r in range(ranks)]
    try:
        for p in procs:
            p.start()
        send.close()
        fields = _wait(procs, recv)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        recv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, value in fields.items():
        setattr(run, name, value)


def _wait(procs, recv) -> dict:
    """Rank 0's readings, once every rank has ended with code 0; raises at
    the first rank that ends otherwise, or after WAIT_S."""
    deadline = time.monotonic() + WAIT_S
    pending = {p.sentinel: r for r, p in enumerate(procs)}
    fields, readable = None, True
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(f"ranks {sorted(pending.values())} still ran "
                               f"after {WAIT_S} s")
        ready = multiprocessing.connection.wait(
            list(pending) + ([recv] if readable else []), timeout=left)
        for obj in ready:
            if obj is recv:
                try:
                    fields = pickle.loads(recv.recv_bytes())
                except EOFError:
                    pass
                readable = False
                continue
            r = pending.pop(obj)
            procs[r].join()
            if procs[r].exitcode != 0:
                raise RuntimeError(f"rank {r} of {len(procs)} ended with "
                                   f"exit code {procs[r].exitcode}")
    if fields is None:
        raise RuntimeError("rank 0 ended without handing over its readings")
    return fields


def _die_with_parent() -> None:
    """Have the kernel kill this process when its parent ends (Linux)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _cpulist(text: str) -> set:
    """The cores of a sysfs cpulist such as "0-15,32-47"."""
    cores: set = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cores.update(range(int(lo), int(hi or lo) + 1))
    return cores


def _card_cores(card: int) -> set:
    """The cores of the NUMA node nearest CUDA card `card`, as sysfs gives
    them; empty where it gives none."""
    props = torch.cuda.get_device_properties(card)
    try:
        bus = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
        with open(f"/sys/bus/pci/devices/{bus}/local_cpulist") as f:
            return _cpulist(f.read())
    except (AttributeError, OSError, ValueError):
        return set()


def rank_cores(rank: int, near: list, allowed: list) -> list:
    """This rank's own share of the cores the run may use (`allowed`):
    the ranks whose cards lie nearest the same cores (`near`, a set a
    rank; an empty or foreign one counts as every allowed core) split
    those cores into contiguous blocks in rank order. Empty where the
    cores are fewer than the ranks that share them."""
    pool = [sorted(set(n) & set(allowed)) or sorted(allowed) for n in near]
    group = [r for r in range(len(near)) if pool[r] == pool[rank]]
    cores, i = pool[rank], group.index(rank)
    size = len(cores) // len(group)
    return cores[i * size:(i + 1) * size]


def _pin(rank: int, ranks: int) -> None:
    """Keep this rank's host threads, which launch a step's kernels and so
    pace it, on cores of their own near its card: no rank's threads then
    share a core with another's or move between the ranks' cores."""
    allowed = sorted(os.sched_getaffinity(0))
    cores = rank_cores(rank, [_card_cores(r) for r in range(ranks)], allowed)
    if cores:
        os.sched_setaffinity(0, cores)
    torch.set_num_threads(max(1, len(cores) or len(allowed) // ranks))
    print(f"portbench: rank {rank} on cores {cores[0]}-{cores[-1]}"
          if cores else f"portbench: rank {rank} unpinned", file=sys.stderr,
          flush=True)


def _rank_main(rank: int, a: dict, conn) -> None:
    _die_with_parent()
    ranks = a["ranks"]
    if a["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        _pin(rank, ranks)
    # One host: the group's bootstrap stays on the loopback interface.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t_rank = time.perf_counter()
    dev = port.join_ranks(ranks, a["store"], rank, a["device"])
    ctrl = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=port.GROUP_TIMEOUT_S))
    phases = {"spawn": t_rank - a["t_spawn"],
              "join": time.perf_counter() - t_rank}
    if a["fault"] is not None:
        from .. import faults

        faults.plant_rank(a["fault"])
    fields = _steps(rank, a, dev, ctrl, phases)
    if rank == 0:
        # Plain pickle: torch's own reduction would hand tensors over as
        # file descriptors, which vanish once this process has ended.
        conn.send_bytes(pickle.dumps(fields))
        conn.close()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steps(rank: int, a: dict, dev, ctrl, phases: dict):
    """One rank's set-up, window and hand-over; rank 0 also checks, and
    returns the run's fields."""
    cfg, tr = a["cfg"], a["traffic"]
    cuda = dev.type == "cuda"
    mesh = port.make_mesh(int(tr["mesh"]["sp"]), int(tr["mesh"]["px"]))
    n_check = int(tr["setup_steps"])
    t_setup = time.perf_counter()
    fs = runner.first_steps(cfg, a["seed"], dev, n_check,
                            int(tr["max_units"]), mesh)
    after = {p: v.detach().cpu() for p, v in fs["leaves"](fs["state"].params)}
    _sync(dev)
    setup_s = time.perf_counter() - a["t_start"]
    phases["setup_steps"] = time.perf_counter() - t_setup

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rule = runner.window_rule(a["trace"], tr, a["seconds"],
                              fs["keys"].shape[0])
    flag = torch.zeros(1, dtype=torch.int64)

    def word(k: int, elapsed: float, traced: bool) -> int:
        # Rank 0's word, the others' STOP: the maximum is rank 0's.
        flag[0] = rule(k, elapsed, traced) if rank == 0 else runner.STOP
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctrl)
        return int(flag[0])

    marks: list = []

    def sync() -> None:
        marks.append(time.perf_counter())
        _sync(dev)

    traces: list = []
    win = runner.step_window(fs, n_check, word, sync, tr, traces)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    phases["window"] = time.perf_counter() - win.t0
    # The host's part of each step: its call up to the synchronize.
    host = [m - (e - d) for m, e, d in zip(marks, win.ends, win.lat)]

    mine = {"peak": peak, "after": after, "bad": env.forbidden_modules(),
            "trace": traces[0].device_part() if traces and rank else None,
            "host": host}
    got = [None] * a["ranks"] if rank == 0 else None
    dist.gather_object(mine, got, dst=0, group=ctrl)
    dist.destroy_process_group()
    if mine["bad"]:
        raise RuntimeError(f"rank {rank} loaded JAX modules: {mine['bad']}")
    if rank != 0:
        return None
    bad = sorted({m for g in got for m in g["bad"]})
    if bad:
        raise RuntimeError(f"ranks loaded JAX modules: {bad}")
    print(step_line(win.lat, [g["host"] for g in got]), file=sys.stderr,
          flush=True)

    r = cfg["render"]
    pix = torch.as_tensor(inputs.sample_pixels(
        a["seed"], int(r["width"]) * int(r["height"]),
        int(tr["check"]["pixels"])), device=dev)
    got_target = fs["target"].reshape(-1, 3).index_select(0, pix)
    kept = {k: fs[k] for k in runner.KEPT}
    del fs
    runner._free()
    t_check = time.perf_counter()
    values = {"rank_param_gap": rank_param_gap([g["after"] for g in got]),
              "target_mismatch_share": target_mismatch_share(
                  got_target, kept, cfg, tr["check"], pix)}
    checks, failed = runner.judge_steps(kept, cfg, dev, n_check, win.finite,
                                        values, tr["check"]["limits"])
    phases["check"] = time.perf_counter() - t_check
    # The check ran in this process, after the look above: look again.
    bad = env.forbidden_modules()
    if bad:
        raise RuntimeError(f"rank 0 loaded JAX modules in the check: {bad}")
    peak_bytes = max(g["peak"] for g in got)
    others = [g["trace"] for g in got[1:]]
    rank_traces = [traces[0]] + others \
        if traces and all(t is not None for t in others) else []
    return {"metrics": {"setup_s": setup_s, **win.metrics(a["seconds"]),
                        "peak_mem_gib": peak_bytes / 2 ** 30},
            "checks": checks, "attempted": len(win.lat), "failed": failed,
            "peak_bytes": peak_bytes, "traces": traces,
            "traced_keys": win.traced_keys, "phases": phases,
            "scene_inputs": kept["start_inputs"], "rank_traces": rank_traces}


def step_line(lat: list, hosts: list) -> str:
    """The window's steps on standard error: rank 0's step seconds by
    quartiles, and each rank's host seconds a step (its call up to the
    synchronize) by median, which tells a slow rank from a slow card."""
    if len(lat) < 2:
        return f"portbench: {len(lat)} steps in the window"
    q = statistics.quantiles(lat, n=4)
    ranks = ", ".join(f"{statistics.median(h):.4f}" if h else "-"
                      for h in hosts)
    return (f"portbench: {len(lat)} steps, s: min {min(lat):.4f}, "
            f"quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, max {max(lat):.4f}"
            f"; host s a step by rank (median): {ranks}")


def target_mismatch_share(got, kept: dict, cfg: dict, ck: dict,
                          pix) -> float:
    """The share of the sampled pixels of the port's target (the sharded
    render's whole image, assembled by its all-reduce) where a channel lies
    beyond atol + rtol * |reference| from the reference's, or is not
    finite: every rank's pixel range, as the frame cells check theirs."""
    r = cfg["render"]
    dev = got.device
    plain = manifest.reference(cfg)
    sc = plain.make_scene(kept["true_inputs"], runner.REF_DTYPE, dev)
    cam = plain.make_camera(cfg["camera"], r["width"] / r["height"],
                            runner.REF_DTYPE, dev)
    with torch.no_grad():
        ref = plain.render_pixels(sc, cam, r, kept["tkey"].to(dev), pix,
                                  runner.REF_DTYPE) / int(r["spp"])
    return check.pixel_mismatch_share(got, ref, float(ck["atol"]),
                                      float(ck["rtol"]))


def rank_param_gap(afters: list) -> float:
    """The largest difference, element by element, between any rank's
    parameters and rank 0's after the set-up steps. The mesh's all-reduce
    hands every rank the same gradient, so every rank takes the same step:
    0 exactly."""
    gap = 0.0
    for other in afters[1:]:
        for name, ref in afters[0].items():
            d = (other[name].to(torch.float64) - ref.to(torch.float64)).abs()
            gap = max(gap, float(d.max()) if d.numel() else 0.0)
            if not torch.isfinite(d).all():
                return float("inf")
    return gap
