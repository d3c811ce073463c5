"""The port's inverse rendering (qt_raytracer_tpu_torch.diff) against the
JAX package on the CPU: train steps of make_train_step (L2 and dual loss)
and of both multi-view steps, from the same state carried across with
utils.convert.train_state_from_arrays (at the start of a run and in the
middle of one, Adam moments included), and the checkpoint round trip.

Both packages render with the plain versions of their kernels
(`fused_interpret`, pinned to `fused_diff_interpret` by
grad_capable_config). Tolerances: parameters within 1e-3 + 1e-3 |ref| after
each step. Adam normalizes each gradient entry by its own running scale, so
the small differences of the gradients (summation order, contracted
multiply-adds; tests/test_torch_gradients.py) move a step by far less than
that; losses within 1e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.tree_util import DictKey, GetAttrKey, tree_flatten_with_path

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.diff import inverse as jinv
from qt_raytracer_tpu.diff import multiview as jmv
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch.core import sampling
from qt_raytracer_tpu_torch.diff import inverse as tinv
from qt_raytracer_tpu_torch.diff import multiview as tmv
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  key_from_words,
                                                  scene_from_arrays,
                                                  train_state_from_arrays)
from torch_helpers import _one_thread  # noqa: F401

KEY = jax.random.PRNGKey(11)
TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _adam_arrays(opt_state):
    """(mu, nu, count) of an optax Adam state (plain or multi_transform),
    as nested dicts shaped like the params."""
    mu, nu, count = {}, {}, 0
    for path, leaf in tree_flatten_with_path(opt_state)[0]:
        names = [k.name for k in path if isinstance(k, GetAttrKey)]
        if names and names[-1] == "count":
            count = int(leaf)
            continue
        if not names or names[-1] not in ("mu", "nu"):
            continue
        keys = [k.key for k in path if isinstance(k, DictKey)][-2:]
        dst = (mu if names[-1] == "mu" else nu).setdefault(keys[0], {})
        dst[keys[1]] = np.asarray(leaf)
    return mu, nu, count


def _carry(jstate, lrs):
    """The port's TrainState from a JAX TrainState."""
    mu, nu, count = _adam_arrays(jstate.opt_state)
    return train_state_from_arrays(_np_tree(jstate.params), mu, nu, count,
                                   int(jstate.step), tinv.adam(lrs),
                                           device="cpu")


def _assert_params_close(tstate, jstate):
    want = dict(tinv.leaves(_np_tree(jstate.params)))
    for path, got in tinv.leaves(tstate.params):
        np.testing.assert_allclose(got.detach().numpy(), want[path],
                                   rtol=TOL, atol=TOL, err_msg=path)
    assert tstate.step == int(jstate.step)


def _assert_first_moments_close(tstate, jstate):
    """Adam's first moment after one step from zero moments is 0.1 g: the
    step's gradients, within 2e-3 |ref| + 2e-3 max|ref| of the JAX ones
    (the standard of tests/test_torch_gradients.py)."""
    mu, _, _ = _adam_arrays(jstate.opt_state)
    want = dict(tinv.leaves(mu))
    for path, p in tinv.leaves(tstate.params):
        got = tstate.opt_state.state[p]["exp_avg"].numpy()
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(got, want[path], rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=path)


def _key(k):
    return key_from_words(np.asarray(jax.random.key_data(k)))


def _three_sphere_case():
    cfg = dict(width=12, height=8, spp=2, max_depth=3, rng="hash",
               intersector="fused_interpret")
    js, jc = jscenes.get_scene("three_sphere", 12 / 8)
    target = np.asarray(jinv.mean_image(js, jc, JConfig(**cfg),
                                        jax.random.PRNGKey(42)))
    wrong = dataclasses.replace(
        js, albedo=js.albedo.at[1].set(jnp.array([0.2, 0.8, 0.6])))
    return cfg, wrong, jc, target


@pytest.mark.parametrize("loss", ["l2", "dual"])
def test_train_step_matches_jax(loss):
    cfg, wrong, jc, target = _three_sphere_case()
    j_init, j_step, _, _ = jinv.make_train_step(
        wrong, jc, JConfig(**cfg), optax.adam(5e-2), trainable=("albedo",),
        loss=loss)
    t_init, t_step, t_rebuild, _ = tinv.make_train_step(
        scene_from_arrays(_arrays(wrong), device="cpu"),
        camera_from_arrays(_arrays(jc), device="cpu"),
        TConfig(**cfg), tinv.adam(5e-2), trainable=("albedo",), loss=loss)
    js, ts = j_init(), t_init()
    assert ts.step == 0
    for it in range(2):
        k = jax.random.fold_in(KEY, it)
        js, jl = j_step(js, jnp.asarray(target), k)
        ts, tl = t_step(ts, torch.tensor(target), _key(k))
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        _assert_params_close(ts, js)
    assert bool((t_rebuild(ts.params["scene"]).albedo != 0).any())


def test_mid_run_state_carried_across_takes_the_same_step():
    cfg, wrong, jc, target = _three_sphere_case()
    j_init, j_step, _, _ = jinv.make_train_step(
        wrong, jc, JConfig(**cfg), optax.adam(5e-2), trainable=("albedo",))
    _, t_step, _, _ = tinv.make_train_step(
        scene_from_arrays(_arrays(wrong), device="cpu"),
        camera_from_arrays(_arrays(jc), device="cpu"),
        TConfig(**cfg), tinv.adam(5e-2), trainable=("albedo",))
    js = j_init()
    for it in range(3):
        js, _ = j_step(js, jnp.asarray(target), jax.random.fold_in(KEY, it))
    ts = _carry(js, 5e-2)
    _assert_params_close(ts, js)
    k = jax.random.fold_in(KEY, 3)
    js, _ = j_step(js, jnp.asarray(target), k)
    ts, _ = t_step(ts, torch.tensor(target), _key(k))
    _assert_params_close(ts, js)
    assert ts.step == 4


def test_train_state_checkpoint_roundtrip(tmp_path):
    # Straight through 4 steps == 2 steps, save, load, 2 more: exactly.
    cfg, wrong, jc, target = _three_sphere_case()
    init, step, _, _ = tinv.make_train_step(
        scene_from_arrays(_arrays(wrong), device="cpu"),
        camera_from_arrays(_arrays(jc), device="cpu"),
        TConfig(**cfg), tinv.adam(5e-2), trainable=("albedo", "emission"),
        train_camera="pose")
    tgt = torch.tensor(target)
    keys = [sampling.fold_in(sampling.prng_key(0), it) for it in range(4)]
    ref = init()
    for k in keys:
        ref, _ = step(ref, tgt, k)
    st = init()
    for k in keys[:2]:
        st, _ = step(st, tgt, k)
    tinv.save_train_state(tmp_path / "ck.pt", st)
    st2 = tinv.load_train_state(tmp_path / "ck.pt", init())
    assert st2.step == 2
    for k in keys[2:]:
        st2, _ = step(st2, tgt, k)
    for (p, a), (_, b) in zip(tinv.leaves(ref.params),
                              tinv.leaves(st2.params)):
        assert torch.equal(a, b), p
    assert st2.step == ref.step == 4


def _lit_scene_arrays():
    """Floor, ball and emitter (tests/test_multiview.py's scene), built by
    the JAX package."""
    from qt_raytracer_tpu.core.scene import SceneBuilder
    b = SceneBuilder()
    b.lambertian((0.0, -100.5, -1.0), 100.0, (0.6, 0.6, 0.6))
    b.lambertian((0.0, 0.0, -1.5), 0.5, (0.75, 0.25, 0.2))
    b.emissive((0.0, 1.6, -1.5), 0.4, (9.0, 9.0, 9.0))
    return b.build(pad_to=8)


def test_multiview_steps_match_jax_and_each_other():
    _multiview_steps_match_jax_and_each_other(edge_aware=False, iters=2)


def test_edge_aware_multiview_steps_match_jax_and_each_other():
    # One edge-aware step of both multi-view step functions: the loss, the
    # updated parameters and the gradients (Adam's first moments).
    _multiview_steps_match_jax_and_each_other(edge_aware=True, iters=1)


def _multiview_steps_match_jax_and_each_other(edge_aware, iters):
    from qt_raytracer_tpu.core.camera import make_camera
    cfg = dict(width=12, height=8, spp=2, max_depth=3, rng="hash", nee=True,
               intersector="fused_interpret")
    scene = _lit_scene_arrays()
    base = make_camera(lookfrom=(0.0, 0.4, 1.2), lookat=(0.0, 0.0, -1.5),
                       vup=(0, 1, 0), vfov=55.0, aspect_ratio=12 / 8,
                       aperture=0.0, focus_dist=1.0)
    offsets = [(0.0, 0.0, 0.0), (0.3, 0.0, 0.0)]
    jcams = jmv.orbit_cameras(base, offsets)
    targets = np.stack([np.asarray(jinv.mean_image(
        scene, c, JConfig(**cfg), jax.random.fold_in(jax.random.PRNGKey(5),
                                                     v)))
        for v, c in enumerate(jcams)])
    wrong = dataclasses.replace(
        scene, albedo=scene.albedo.at[1].set(jnp.array([0.3, 0.5, 0.5])),
        emission=scene.emission.at[2].set(jnp.array([6.0, 6.0, 6.0])))
    lrs = {"scene/albedo": 0.03, "scene/emission": 0.6,
           "camera/translate": 2.5e-2}
    opt = optax.multi_transform(
        {"scene": optax.adam(0.03), "emission": optax.adam(0.6),
         "camera": optax.adam(2.5e-2)},
        {"scene": {"albedo": "scene", "emission": "emission"},
         "camera": {"translate": "camera"}})
    j_init, j_step, _, _ = jmv.make_multiview_train_step(
        wrong, jcams, JConfig(**cfg), opt, edge_aware=edge_aware)
    tscene = scene_from_arrays(_arrays(wrong), device="cpu")
    tcams = tmv.orbit_cameras(camera_from_arrays(_arrays(base),
                                                 device="cpu"), offsets)
    steps = {
        make: make(tscene, tcams, TConfig(**cfg), tinv.adam(lrs),
                   edge_aware=edge_aware)[1]
        for make in (tmv.make_multiview_train_step,
                     tmv.make_multiview_train_step_perview)}
    js = j_init()
    ts = {make: _carry(js, lrs) for make in steps}
    for it in range(iters):
        k = jax.random.fold_in(KEY, it)
        js, jl = j_step(js, jnp.asarray(targets), k)
        losses = []
        for make, step in steps.items():
            ts[make], tl = step(ts[make], torch.tensor(targets), _key(k))
            np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
            _assert_params_close(ts[make], js)
            if it == 0:
                _assert_first_moments_close(ts[make], js)
            losses.append(float(tl))
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    a, b = (dict(tinv.leaves(s.params)) for s in ts.values())
    for path in a:
        np.testing.assert_allclose(a[path].detach().numpy(),
                                   b[path].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=path)


def test_render_targets_is_the_mean_image():
    cfg = TConfig(width=12, height=8, spp=4, max_depth=3, rng="hash",
                  nee=True)
    scene = scene_from_arrays(_arrays(_lit_scene_arrays()), device="cpu")
    from qt_raytracer_tpu_torch.core.camera import make_camera
    cam = make_camera((0.0, 0.4, 1.2), (0.0, 0.0, -1.5), vfov=55.0,
                      aspect_ratio=cfg.aspect_ratio, device="cpu")
    cams = tmv.orbit_cameras(cam, [(0, 0, 0), (0.2, 0, 0)])
    tgt = tmv.render_targets(scene, cams, cfg, seed=5, spp_per_call=3)
    for v, c in enumerate(cams):
        ref = tinv.mean_image(scene, c, cfg, 5 + 1000 * v)
        torch.testing.assert_close(tgt[v], ref, atol=1e-5, rtol=1e-5)


def test_unported_training_options_raise():
    cfg, wrong, jc, _ = _three_sphere_case()
    args = (scene_from_arrays(_arrays(wrong), device="cpu"),
    camera_from_arrays(_arrays(jc), device="cpu"),
            TConfig(**cfg), tinv.adam(1e-2))
    with pytest.raises(TypeError, match="Mesh"):
        tinv.make_train_step(*args, mesh=object())
    with pytest.raises(ValueError, match="'l2' or 'dual'"):
        tinv.make_train_step(*args, loss="l1")
    with pytest.raises(ValueError, match="'pose' or False"):
        tmv.make_multiview_train_step(args[0], [args[1]], *args[2:],
                                      train_camera=True)


def test_edge_aware_train_step_matches_jax():
    # One edge-aware step of make_train_step on albedo, sphere centers and
    # the camera pose: the loss, the updated parameters and the gradients
    # (Adam's first moments) against the JAX package. The pose and center
    # gradients are the boundary term's: they differ from the pathwise
    # step's on the same key.
    cfg, wrong, jc, target = _three_sphere_case()
    kw = dict(trainable=("albedo", "center"), train_camera="pose")
    j_init, j_step, _, _ = jinv.make_train_step(
        wrong, jc, JConfig(**cfg), optax.adam(5e-2), edge_aware=True, **kw)
    tscene = scene_from_arrays(_arrays(wrong), device="cpu")
    tcam = camera_from_arrays(_arrays(jc), device="cpu")
    t_init, t_step, _, _ = tinv.make_train_step(
        tscene, tcam, TConfig(**cfg), tinv.adam(5e-2), edge_aware=True, **kw)
    k = jax.random.fold_in(KEY, 0)
    js, jl = j_step(j_init(), jnp.asarray(target), k)
    ts, tl = t_step(t_init(), torch.tensor(target), _key(k))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    _assert_params_close(ts, js)
    _assert_first_moments_close(ts, js)

    p_init, p_step, _, _ = tinv.make_train_step(
        tscene, tcam, TConfig(**cfg), tinv.adam(5e-2), **kw)
    ps, pl = p_step(p_init(), torch.tensor(target), _key(k))
    assert float(pl) == float(tl)                     # primal zero
    moment = lambda st: st.opt_state.state[
        st.params["camera"]["translate"]]["exp_avg"]
    assert not torch.allclose(moment(ps), moment(ts), rtol=1e-2, atol=0.0)
