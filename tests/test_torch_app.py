"""The port's app layer (progressive and checkpointed renders, stats, PNG
writer, preview, profiling, the OBJ loader and the CLI) on the CPU: the
cases of tests/test_app.py, and the port held against the JAX package's app
layer on the same inputs.

Tolerances: k progressive steps of 1 spp equal a batch render bit for bit
(the sums run in the same order); steps of n > 1 spp add partial sums, so
atol = rtol = 1e-5 as in tests/test_app.py. Against JAX (whose CPU render
takes the portable XLA search, the port the plain fused path) the image
budget of tests/test_torch_render.py: at most 1% of channels beyond 2e-3 +
2e-3 |ref|; PNGs at most 1% of pixels more than one level apart. Stats,
letterbox, ANSI frames, AA presets and OBJ loads: equal.
"""

import argparse
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.app import cli as jcli
from qt_raytracer_tpu.app import preview as jpreview
from qt_raytracer_tpu.app.progressive import ProgressiveRenderer as JProgressive
from qt_raytracer_tpu.app.stats import RenderStats as JStats
from qt_raytracer_tpu.core.config import AA_PRESETS as J_AA_PRESETS
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu.runtime import native_bvh as jnative
import qt_raytracer_tpu_torch as qt
from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.app import cli, preview, profiling
from qt_raytracer_tpu_torch.app.png import encode_png, write_png
from qt_raytracer_tpu_torch.app.progressive import ProgressiveRenderer
from qt_raytracer_tpu_torch.app.stats import RenderStats
from qt_raytracer_tpu_torch.runtime import native_bvh
from qt_raytracer_tpu_torch.utils.convert import (
    camera_from_arrays, progressive_state_from_arrays, scene_from_arrays)
from torch_helpers import _one_thread  # noqa: F401

CFG = RenderConfig(width=16, height=12, spp=6, max_depth=3)
ATOL = RTOL = 2e-3
MAX_MISMATCH = 0.01
SMALL = ["--scene", "three_sphere", "--width", "16", "--height", "12",
         "--spp", "2", "--depth", "3"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (see test_torch_edge.py).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


@pytest.fixture(scope="module")
def scene_cam():
    return scenes.get_scene("three_sphere", CFG.aspect_ratio, device="cpu")


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect):
    js, jc = jscenes.get_scene(name, aspect)
    return (js, jc), (scene_from_arrays(_arrays(js), device="cpu"),
                      camera_from_arrays(_arrays(jc), device="cpu"))


def _within_budget(got, want):
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert bad.mean() <= MAX_MISMATCH, bad.mean()


# ------------------------------------------------------------ progressive
def test_progressive_equals_batch(scene_cam):
    # k steps of n spp equal one batch render at k*n spp with the same seed
    # (GpuPathTracer.cpp:279-282's running mean made interchangeable).
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(2)
    pr.step(3)
    mean = pr.step(1)
    assert pr.frame_index == 6 and pr.progress == 100.0
    batch = render_linear(scene, cam, CFG, 0)
    torch.testing.assert_close(pr.state.accum, batch, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mean, pr.state.accum / 6, atol=0, rtol=0)


@pytest.mark.parametrize("rng", ["hash", "threefry"])
def test_progressive_1spp_steps_equal_batch_bitwise(scene_cam, rng):
    scene, cam = scene_cam
    cfg = dataclasses.replace(CFG, rng=rng)
    pr = ProgressiveRenderer(scene, cam, cfg, seed=5)
    for _ in range(cfg.spp):
        pr.step(1)
    assert torch.equal(pr.state.accum, render_linear(scene, cam, cfg, 5))
    assert not pr.state.accum.requires_grad


def test_progressive_world_equals_batch_bitwise():
    # A mesh world goes through the same renderer (World from get_scene).
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=2, nee=True)
    world, cam = scenes.get_scene("cornell_mesh", cfg.aspect_ratio,
                                  device="cpu", builder="numpy")
    pr = ProgressiveRenderer(world, cam, cfg, seed=1)
    pr.step(1)
    pr.step(1)
    assert torch.equal(pr.state.accum, render_linear(world, cam, cfg, 1))
    assert pr.image().shape == (12, 16, 3)


def test_progressive_reset(scene_cam):
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(2)
    pr.reset()
    assert pr.frame_index == 0
    assert float(pr.state.accum.abs().max()) == 0.0


def test_checkpoint_resume(tmp_path, scene_cam):
    # Interrupt at 3 spp, save, restore into a fresh renderer built with a
    # wrong seed, finish: equals the uninterrupted 6-spp accumulation.
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(3)
    ck = tmp_path / "ckpt.pt"
    pr.save(ck)

    pr2 = ProgressiveRenderer(scene, cam, CFG, seed=99)  # wrong seed on purpose
    pr2.load(ck)
    assert pr2.frame_index == 3 and pr2.state.seed == 0 and pr2.seed == 0
    assert pr2.state.accum.device == pr2.device
    pr2.step(3)

    full = ProgressiveRenderer(scene, cam, CFG, seed=0)
    full.step(6)
    torch.testing.assert_close(pr2.state.accum, full.state.accum,
                               atol=1e-5, rtol=1e-5)


def test_checkpoint_refuses_another_image_size(tmp_path, scene_cam):
    scene, cam = scene_cam
    pr = ProgressiveRenderer(scene, cam, CFG, seed=0)
    pr.step(1)
    pr.save(tmp_path / "ck.pt")
    other = ProgressiveRenderer(scene, cam,
                                dataclasses.replace(CFG, width=8), seed=0)
    with pytest.raises(ValueError, match="accumulation"):
        other.load(tmp_path / "ck.pt")


@pytest.mark.parametrize("rng", ["hash", "threefry"])
def test_progressive_matches_jax(rng):
    cfg_kw = dict(width=16, height=12, spp=3, max_depth=3, rng=rng)
    (js, jc), (ts, tc) = _both("random", 16 / 12)
    jpr = JProgressive(js, jc, JConfig(**cfg_kw), seed=2)
    jpr.step(2)
    jpr.step(1)
    tpr = ProgressiveRenderer(ts, tc, RenderConfig(**cfg_kw), seed=2)
    tpr.step(2)
    tpr.step(1)
    assert tpr.frame_index == jpr.frame_index == 3
    _within_budget(tpr.state.accum.numpy() / 3, np.asarray(jpr.state.accum) / 3)
    levels = np.abs(tpr.image().astype(int) - np.asarray(jpr.image()).astype(int))
    assert (levels > 1).mean() <= MAX_MISMATCH


def test_progressive_state_from_arrays():
    # JAX traces 3 spp, the port continues 3 more from JAX's state: the
    # result is held against JAX's own 6.
    cfg_kw = dict(width=16, height=12, spp=6, max_depth=3, rng="hash")
    (js, jc), (ts, tc) = _both("three_sphere", 16 / 12)
    jpr = JProgressive(js, jc, JConfig(**cfg_kw), seed=4)
    jpr.step(3)
    state = progressive_state_from_arrays(np.asarray(jpr.state.accum),
                                          jpr.state.sample_count,
                                          jpr.state.seed, device="cpu")
    tpr = ProgressiveRenderer(ts, tc, RenderConfig(**cfg_kw), seed=0)
    tpr.state = state
    tpr.step(3)
    jpr.step(3)
    assert tpr.frame_index == 6
    _within_budget(tpr.state.accum.numpy() / 6, np.asarray(jpr.state.accum) / 6)
    with pytest.raises(ValueError, match="H, W, 3"):
        progressive_state_from_arrays(np.zeros((4, 4)), 1, 0, device="cpu")


# ------------------------------------------------------------------ stats
def test_stats_formulas():
    st = RenderStats(width=400, height=225, spp=24, max_depth=10,
                     elapsed_s=2.0, frames=4)
    # W*H*spp/elapsed (RayTracerFboItem.cpp:400-404)
    assert st.msamples_per_s == pytest.approx(400 * 225 * 24 / 2.0 / 1e6)
    assert st.fps == pytest.approx(2.0)
    assert st.mrays_per_s == pytest.approx(st.msamples_per_s * 10)
    assert "Msamples/s" in st.text() and "cuda" in st.text()


@pytest.mark.parametrize("kw", [
    dict(width=400, height=225, spp=24, max_depth=10, elapsed_s=2.0,
         frames=4, backend="cpu"),
    dict(width=1920, height=1080, spp=1, max_depth=10, elapsed_s=0.113,
         backend="cuda", num_chips=4),
    dict(width=16, height=12, spp=3, max_depth=3, elapsed_s=0.0),
])
def test_stats_match_jax(kw):
    kw = {"backend": "cuda", **kw}
    ours, theirs = RenderStats(**kw), JStats(**kw)
    for name in ("samples", "msamples_per_s", "fps", "mrays_per_s",
                 "msamples_per_s_per_chip"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.text() == theirs.text()


# -------------------------------------------------------------------- png
@pytest.mark.parametrize("shape", [(1, 1), (12, 16), (5, 7), (225, 400)])
def test_png_writer_decodes_to_its_array(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)


def test_png_writer_refuses_other_arrays():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((4, 4, 4), np.uint8), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            encode_png(bad)


# -------------------------------------------------------------------- cli
def test_cli_render(tmp_path):
    out = tmp_path / "img.png"
    rc = cli.main(["render", *SMALL, "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.exists()
    with Image.open(out) as im:
        assert im.size == (16, 12)


def test_cli_render_matches_jax_cli(tmp_path):
    ours, theirs = tmp_path / "ours.png", tmp_path / "jax.png"
    assert cli.main(["render", *SMALL, "--device", "cpu",
                     "--out", str(ours)]) == 0
    args = jcli.build_parser().parse_args(
        ["render", *SMALL, "--backend", "cpu", "--out", str(theirs)])
    assert jcli.cmd_render(args) == 0
    with Image.open(ours) as a, Image.open(theirs) as b:
        got, want = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert got.shape == want.shape == (12, 16, 3)
    assert (np.abs(got - want).max(axis=2) > 1).mean() <= MAX_MISMATCH


def test_cli_render_progressive_resume(tmp_path, capsys):
    ck = tmp_path / "ck.pt"
    out1, out2 = tmp_path / "a.png", tmp_path / "b.png"
    args = ["render", *SMALL[:6], "--spp", "4", "--depth", "3",
            "--device", "cpu", "--progressive", "--batch", "2",
            "--checkpoint", str(ck)]
    assert cli.main(args + ["--out", str(out1)]) == 0
    assert "progress 100.0% (4/4 spp)" in capsys.readouterr().err
    # Resume from the finished checkpoint: adds nothing (already at spp).
    assert cli.main(args + ["--resume", "--out", str(out2)]) == 0
    assert "resumed at 4 spp" in capsys.readouterr().err
    with Image.open(out1) as a, Image.open(out2) as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_progressive_interrupt_saves_and_resumes(tmp_path, monkeypatch,
                                                   capsys):
    # Ctrl-C between steps keeps the partial accumulation in the checkpoint
    # (stopRender analog); --resume finishes it as an uninterrupted run.
    from qt_raytracer_tpu_torch.app import progressive
    real_step = progressive.ProgressiveRenderer.step
    steps = []

    def step(self, num_samples=1):
        if steps:
            raise KeyboardInterrupt
        steps.append(num_samples)
        return real_step(self, num_samples)

    base = ["render", *SMALL[:6], "--spp", "4", "--depth", "3",
            "--device", "cpu", "--progressive", "--batch", "2"]
    ck = tmp_path / "ck.pt"
    monkeypatch.setattr(progressive.ProgressiveRenderer, "step", step)
    assert cli.main(base + ["--checkpoint", str(ck),
                            "--out", str(tmp_path / "part.png")]) == 0
    assert "interrupted at 2/4 spp; checkpoint saved" in \
        capsys.readouterr().err
    monkeypatch.undo()
    assert cli.main(base + ["--checkpoint", str(ck), "--resume",
                            "--out", str(tmp_path / "resumed.png")]) == 0
    assert "resumed at 2 spp" in capsys.readouterr().err
    assert cli.main(base + ["--out", str(tmp_path / "whole.png")]) == 0
    assert (tmp_path / "resumed.png").read_bytes() == \
        (tmp_path / "whole.png").read_bytes()


def test_cli_invert_interrupt_saves_and_resumes(tmp_path, monkeypatch,
                                               capsys):
    from qt_raytracer_tpu_torch.diff import inverse
    real_make = inverse.make_train_step

    def make_train_step(*args, **kw):
        init, step_fn, rebuild, rebuild_cam = real_make(*args, **kw)

        def step_once(state, target, key):
            if state.step >= 1:
                raise KeyboardInterrupt
            return step_fn(state, target, key)

        return init, step_once, rebuild, rebuild_cam

    ck = tmp_path / "inv.pt"
    argv = ["invert", *SMALL, "--device", "cpu", "--steps", "2",
            "--checkpoint", str(ck)]
    monkeypatch.setattr(inverse, "make_train_step", make_train_step)
    assert cli.main(argv) == 130 and ck.exists()
    assert "interrupted at step 1; optimizer state saved" in \
        capsys.readouterr().err
    monkeypatch.undo()
    assert cli.main(argv + ["--resume"]) == 0
    captured = capsys.readouterr()
    assert "resumed at step 1" in captured.err
    assert "step    1 loss" in captured.out


@pytest.mark.parametrize("extra", [["--scene", "cornell_mesh"],
                                   ["--scene", "cornell", "--nee"]])
def test_cli_render_mesh_world_and_nee(tmp_path, extra):
    from qt_raytracer_tpu_torch import render
    out = tmp_path / "w.png"
    assert cli.main(["render", *SMALL[2:], *extra, "--device", "cpu",
                     "--out", str(out)]) == 0
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3,
                       nee="--nee" in extra)
    scene, cam = scenes.get_scene(extra[1], cfg.aspect_ratio, device="cpu")
    assert out.read_bytes() == encode_png(render(scene, cam, cfg, 0).numpy())


def test_cli_bench_json_has_the_jax_keys(capsys):
    assert cli.main(["bench", *SMALL, "--device", "cpu", "--iters", "1"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    args = jcli.build_parser().parse_args(
        ["bench", *SMALL, "--backend", "cpu", "--iters", "1"])
    assert jcli.cmd_bench(args) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(ours) == list(theirs)
    assert ours["msamples_per_s"] > 0 and ours["backend"] == "cpu"
    for k in ("scene", "width", "height", "spp", "depth", "nee"):
        assert ours[k] == theirs[k], k


def test_cli_invert_steps(tmp_path, capsys):
    ck = tmp_path / "inv.pt"
    rc = cli.main(["invert", *SMALL, "--device", "cpu", "--steps", "2",
                   "--checkpoint", str(ck)])
    out = capsys.readouterr().out
    assert rc == 0 and ck.exists()
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "recovered albedo" in out
    # Resuming at the last step has nothing left to take.
    assert cli.main(["invert", *SMALL, "--device", "cpu", "--steps", "2",
                     "--checkpoint", str(ck), "--resume"]) == 0
    assert "resumed at step 2" in capsys.readouterr().err


@pytest.mark.parametrize("extra,steps", [(["--train-camera"], 2),
                                         (["--train-camera", "--edge-aware"],
                                          1)])
def test_cli_invert_train_camera(capsys, extra, steps):
    rc = cli.main(["invert", *SMALL, "--device", "cpu", "--steps",
                   str(steps), *extra])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert rc == 0 and len(losses) == steps and np.isfinite(losses).all()
    origin = [line for line in out.splitlines()
              if line.startswith("recovered camera origin")]
    assert len(origin) == 1
    err = float(origin[0].rsplit("err ", 1)[1].rstrip(")"))
    assert np.isfinite(err)


@pytest.mark.parametrize("edge_aware", [False, True])
def test_invert_learning_rate_by_leaf(edge_aware):
    # Adam's first step moves each leaf by its own rate: the camera's is
    # 0.05 lr without the boundary term (the dict of rates), lr with it.
    from qt_raytracer_tpu_torch.core.sampling import fold_in
    from qt_raytracer_tpu_torch.diff.inverse import leaves
    args = cli.build_parser().parse_args(
        ["invert", *SMALL, "--device", "cpu", "--train-camera"]
        + ["--edge-aware"] * edge_aware)
    _, _, key, target, init_state, step_fn, _ = cli.invert_problem(
        args, cli.invert_config(args), torch.device("cpu"))
    state = init_state()
    before = {p: t.detach().clone() for p, t in leaves(state.params)}
    state, _ = step_fn(state, target, fold_in(key, 1))
    rates = {"scene/albedo": args.lr,
             "camera/translate": args.lr * (1.0 if edge_aware else 0.05)}
    moved = {p: float((t.detach() - before[p]).abs().max())
             for p, t in leaves(state.params)}
    assert set(moved) == set(rates)
    for p, rate in rates.items():
        assert abs(moved[p] - rate) <= 1e-3 * rate, (p, moved[p], rate)


@pytest.mark.parametrize("aa", sorted(J_AA_PRESETS))
def test_cli_aa_preset(tmp_path, aa):
    args = cli.build_parser().parse_args(
        ["render", "--aa", aa, "--out", str(tmp_path / "x.png")])
    assert cli._build_cfg(args).spp == J_AA_PRESETS[aa] == qt.AA_PRESETS[aa]


def test_cli_flags_are_the_jax_clis():
    # The same subcommands and flags, with --device in place of --backend.
    def flags(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: ({o for a in sp._actions for o in a.option_strings},
                       {a.dest: a.default for a in sp._actions})
                for name, sp in sub.choices.items()}
    ours, theirs = flags(cli.build_parser()), flags(jcli.build_parser())
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert ours[name][0] - {"--device"} == theirs[name][0] - {"--backend"}
        d_ours = {k: v for k, v in ours[name][1].items() if k != "device"}
        d_theirs = {k: v for k, v in theirs[name][1].items()
                    if k not in ("backend", "fn")}
        d_ours.pop("fn", None)
        assert d_ours == d_theirs, name
        assert ours[name][1]["device"] == "cuda"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")


@pytest.mark.parametrize("cmd", ["render", "preview", "interactive", "bench",
                                 "invert"])
def test_cli_without_device_refuses_without_cuda(cmd, capsys):
    _no_cuda()
    assert cli.main([cmd, *SMALL]) != 0
    assert "CUDA" in capsys.readouterr().err


def test_cli_module_without_device_exits_naming_cuda(tmp_path):
    _no_cuda()
    out = tmp_path / "never.png"
    proc = subprocess.run(
        [sys.executable, "-m", "qt_raytracer_tpu_torch.app.cli", "render",
         *SMALL, "--out", str(out)], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr
    assert not out.exists()


# ---------------------------------------------------------------- preview
def test_letterbox_aspect_preserved():
    img = np.full((100, 200, 3), 255, np.uint8)  # 2:1 source
    out = preview.letterbox(img, 100, 100)       # square target
    assert out.shape == (100, 100, 3)
    # vertical black bars above/below a 100x50 fitted image
    assert out[:24].max() == 0 and out[-24:].max() == 0
    assert out[50].max() == 255


def test_ansi_frame_shape():
    img = np.random.default_rng(0).integers(0, 255, (30, 40, 3), np.uint8)
    s = preview.ansi_frame(img, cols=20)
    lines = s.split("\n")
    assert all("▀" in ln for ln in lines)
    assert len(lines) >= 4


@pytest.mark.parametrize("src,target", [((30, 40), (20, 9)),
                                        ((12, 16), (80, 60)),
                                        ((100, 37), (33, 33))])
def test_letterbox_and_ansi_frame_equal_jax(src, target):
    img = np.random.default_rng(src[0]).integers(0, 256, (*src, 3), np.uint8)
    np.testing.assert_array_equal(preview.letterbox(img, *target),
                                  jpreview.letterbox(img, *target))
    assert preview.ansi_frame(img, target[0]) == \
        jpreview.ansi_frame(img, target[0])


def test_run_preview_smoke(tmp_path, scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=2)
    buf = io.StringIO()
    out = tmp_path / "prev.png"
    pr = preview.run_preview(scene, cam, cfg, batch=1, out_path=str(out),
                             ansi=False, stream=buf)
    assert pr.frame_index == 2 and out.exists()
    assert "progress 100.0%" in buf.getvalue()
    with Image.open(out) as im:
        np.testing.assert_array_equal(np.asarray(im), pr.image())


# -------------------------------------------------------------- profiling
def test_trace_writes_the_annotated_span(tmp_path, scene_cam):
    scene, cam = scene_cam
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=1)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("qtrt_test_span"):
            render_linear(scene, cam, cfg, 0)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        assert "qtrt_test_span" in f.read()


def test_trace_is_written_when_the_run_fails(tmp_path):
    with pytest.raises(RuntimeError, match="failed run"):
        with profiling.trace(str(tmp_path)) as prof:
            with profiling.annotate("qtrt_failed_span"):
                torch.ones(4).sum()
                raise RuntimeError("failed run")
    with open(prof.trace_path) as f:
        assert "qtrt_failed_span" in f.read()


def test_device_memory_stats_without_cuda():
    _no_cuda()
    assert profiling.device_memory_stats() == []


# ------------------------------------------------------- package and OBJ
def test_package_exports():
    assert qt.AA_PRESETS == J_AA_PRESETS
    from qt_raytracer_tpu_torch.core.render import render_sample_batch
    from qt_raytracer_tpu_torch.core.world import as_world
    assert qt.render_sample_batch is render_sample_batch
    assert qt.as_world is as_world
    assert qt.tonemap.to_uint8 is not None


OBJ = ("# comment\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 2 1 0.5\n"
       "f 1 2 3\nf 2/1 4/2 3/3\nf -4//1 -3//2 -2//3\nf 1 2 5 4\n"
       "vn 0 0 1\nf -5/1/1 -4/2/1 -1/3/1\n")


def test_load_obj_matches_jax(tmp_path):
    p = tmp_path / "quads.obj"
    p.write_text(OBJ)
    want_v, want_f = jnative._load_obj_python(str(p))
    assert want_f.shape == (6, 3)          # a quad fans into two triangles
    for ours, theirs in ((native_bvh.load_obj, jnative.load_obj),
                         (native_bvh._load_obj_python,
                          jnative._load_obj_python)):
        v, f = ours(str(p))
        jv, jf = theirs(str(p))
        assert v.dtype == np.float32 and f.dtype == np.int32
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(v, want_v)
        np.testing.assert_array_equal(f, want_f)
