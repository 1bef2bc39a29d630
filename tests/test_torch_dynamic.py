"""The dynamic and compressed models of the port against the JAX package
on the CPU.

- ``posenc``, ``DeformationMLP``, ``HexPlaneField`` and
  ``apply_deformation`` with the JAX networks' weights carried across
  (``load_flax``): atol 1e-5. Fresh networks initialise as flax does.
- One dynamic step from a carried-across state against
  ``make_dynamic_train_step`` (refine and noise outside the window), held
  as ``tests/test_torch_train_options.py`` holds a step: the loss rtol
  1e-5, the splats' and the network's gradients (read from the Adam
  moments) atol 3e-4, the densification statistics; the network's Adam
  against optax's within float32 rounding.
- ``evaluate_dynamic``; the CLI run of ``tests/test_dynamic.py:122-144``
  and the checkpoint round trip of ``:145``, the state read back bitwise.
- The compressed model: its decoders with carried weights, the
  straight-through quantiser, ``distill``'s loss falling, and the npz
  read across packages.

JAX renders through its XLA ``"tiles"`` route, the port through the
kernels' plain versions.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.models import compressed as JCM
from divshot_tpu.models import dynamic as JD

from divshot_tpu_torch.apps import train as train_app
from divshot_tpu_torch.core.config import DensifyStrategy, TrainConfig
from divshot_tpu_torch.models import compressed as TCM
from divshot_tpu_torch.models import dynamic as TD
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train import checkpoint as CK
from divshot_tpu_torch.train.optim import PARAM_FIELDS
from divshot_tpu_torch.train.trainer import Dataset
from tests.test_dynamic import _write_dnerf_dataset, dynamic_setup

CPU = "cpu"
FIELDS = (*PARAM_FIELDS, "alive")
JRK = {"backend": "tiles", "tile_capacity": 512, "instance_capacity": 1 << 14}
TRK = {"instance_capacity": 1 << 14}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _randomised(tree, seed):
    """A flax tree with every leaf replaced by normal noise of its scale
    (0.3 where the leaf is all zeros: the heads)."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        s = float(np.abs(x).mean()) or 0.3
        return jnp.asarray(rng.normal(0, s, x.shape).astype(np.float32))
    return jax.tree.map(leaf, tree)


def _port_params(jp) -> GaussianParams:
    return GaussianParams.from_numpy({f: _np(getattr(jp, f)) for f in FIELDS},
                                     device=CPU)


def _port_dataset(jds) -> Dataset:
    cams = []
    for i in range(jds.num_views):
        jc = jax.tree.map(lambda x: x[i], jds.cameras)
        cams.append(Camera.from_numpy(
            {k: _np(getattr(jc, k)) for k in ("viewmat", "fx", "fy", "cx",
                                              "cy", "width", "height")},
            device=CPU))
    ds = Dataset.from_views(cams, _np(jds.images))
    ds.times = np.asarray(jds.times, np.float32)
    return ds


NETS = {
    "mlp_small": (lambda: JD.DeformationMLP(width=64, depth=3),
                  lambda: TD.DeformationMLP(width=64, depth=3)),
    "mlp_default": (JD.DeformationMLP, TD.DeformationMLP),
    "hexplane_small": (
        lambda: JD.HexPlaneField(resolution=32, time_resolution=16,
                                 features=8),
        lambda: TD.HexPlaneField(resolution=32, time_resolution=16,
                                 features=8)),
    "hexplane_default": (JD.HexPlaneField, TD.HexPlaneField),
}


def test_posenc_matches_jax():
    x = np.random.default_rng(0).normal(0, 2, (50, 3)).astype(np.float32)
    for f in (1, 4, 10):
        np.testing.assert_allclose(TD.posenc(torch.from_numpy(x), f).numpy(),
                                   _np(JD.posenc(jnp.asarray(x), f)),
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(NETS))
def test_networks_match_jax_with_carried_weights(name):
    jmake, tmake = NETS[name]
    jnet, tnet = jmake(), tmake()
    rng = np.random.default_rng(1)
    # means inside and outside the HexPlane's bounds, times outside [0, 1]
    x = rng.uniform(-2.0, 2.0, (200, 3)).astype(np.float32)
    t = rng.uniform(-0.2, 1.2, 200).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x[:8]),
                        jnp.zeros((8,)))
    # flax's initialisation: zero heads, ones and U[0, 0.1) planes
    got = TD.flax_named(_tree_np(jparams))
    own = dict(tnet.named_parameters())
    assert set(got) == set(own)
    for k, p in own.items():
        assert p.shape == got[k].shape, k
        if k.startswith("head_") or k.endswith(".bias"):
            assert not p.detach().any() and not got[k].any(), k
        elif k.startswith("plane_"):
            lo, hi = (0.0, 0.1) if k.endswith("t") else (1.0, 1.0)
            assert lo <= float(p.detach().min()) <= float(p.detach().max()) \
                <= hi + 1e-7
        else:   # LeCun normal, truncated at two standard deviations
            std = (1.0 / p.shape[1]) ** 0.5
            assert float(p.detach().abs().max()) <= 2 * std / 0.8796 + 1e-6
            assert abs(float(p.detach().std()) / std - 1) < 0.2, k
    jparams = _randomised(jparams, 2)
    TD.load_flax(tnet, _tree_np(jparams))
    with torch.no_grad():
        for tt in (t, 0.37):
            ref = jnet.apply(jparams, jnp.asarray(x), jnp.asarray(tt))
            out = tnet(torch.from_numpy(x), tt if np.isscalar(tt)
                       else torch.from_numpy(tt))
            for k in ("dxyz", "drot", "dscale"):
                np.testing.assert_allclose(out[k].numpy(), _np(ref[k]),
                                           atol=1e-5, err_msg=k)
    # the parameters' gradients of a weighted sum of the deltas (the
    # planes' through the gathers' backward), within 1e-5 of the largest
    w = {k: rng.normal(size=(200, n)).astype(np.float32)
         for k, n in (("dxyz", 3), ("drot", 4), ("dscale", 3))}

    def jloss(prm):
        d = jnet.apply(prm, jnp.asarray(x), jnp.asarray(t))
        return sum(jnp.sum(d[k] * w[k]) for k in w)

    jg = TD.flax_named(_tree_np(jax.grad(jloss)(jparams)))
    d = tnet(torch.from_numpy(x), torch.from_numpy(t))
    sum((d[k] * torch.from_numpy(w[k])).sum() for k in w).backward()
    for k, p in tnet.named_parameters():
        scale = max(float(np.abs(jg[k]).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), jg[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    # apply_deformation
    from divshot_tpu.gsio.synthetic import random_scene
    js = random_scene(rng, 64, sh_degree=0)
    d = jnet.apply(jparams, js.means, jnp.float32(0.5))
    ts = _port_params(js)
    with torch.no_grad():
        out = TD.apply_deformation(ts, tnet(ts.means, 0.5))
    ref = JD.apply_deformation(js, d)
    for f in ("means", "quats", "scales"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   _np(getattr(ref, f)), atol=1e-5)
    assert torch.equal(out.sh0, ts.sh0)


def test_fresh_networks_follow_the_seed():
    a, b = TD.DeformationMLP(seed=3), TD.DeformationMLP(seed=3)
    c = TD.DeformationMLP(seed=4)
    for (k, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q)
        if k.startswith("dense") and k.endswith("weight"):
            assert not torch.equal(p, r)
    assert isinstance(TD.net_for_model_type(3), TD.HexPlaneField)
    assert isinstance(TD.net_for_model_type(2), TD.DeformationMLP)


def test_net_adam_matches_optax():
    rng = np.random.default_rng(4)
    p0 = {"a.weight": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    named = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tx = optax.adam(8e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    ts = TD.NetAdamState.init(named)
    for step in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 10 ** -step
             for k, v in p0.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = TD.net_adam_update(named, {k: torch.from_numpy(v)
                                        for k, v in g.items()}, ts, 8e-4)
        for k in p0:
            np.testing.assert_allclose(named[k].numpy(), _np(jp[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts.mu[k].numpy(), _np(js[0].mu[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(ts.nu[k].numpy(), _np(js[0].nu[k]),
                                       rtol=1e-6)
    assert ts.count == int(js[0].count) == 4


# ---------------------------------------------------------------------------
# one step, evaluation


def _configure(cfg):
    """ADC+ (no MCMC noise, which draws every step), the deformation on
    from step 1, no refine."""
    cfg.densify.strategy = DensifyStrategy.ADC_PLUS
    cfg.densify.warmup_length = 1
    cfg.densify.refine_every = 10_000
    return cfg


def _jax_cfg():
    return _configure(JTrainConfig(sh_degree=0))


def _port_cfg(capacity):
    cfg = _configure(TrainConfig(sh_degree=0))
    cfg.densify.cap_max = capacity
    return cfg


def _carry_state(js, net) -> TD.DynTrainState:
    d = {"params": {f: _np(getattr(js.params, f)) for f in FIELDS},
         "mu": {f: _np(v) for f, v in js.opt.mu.items()},
         "nu": {f: _np(v) for f, v in js.opt.nu.items()},
         "step": int(js.opt.step),
         "dstate": {k: _np(getattr(js.dstate, k)) for k in (
             "grad_accum", "count", "max_radii")},
         "net_params": _tree_np(js.net_params),
         "net_opt": {"mu": _tree_np(js.net_opt[0].mu),
                     "nu": _tree_np(js.net_opt[0].nu),
                     "count": int(js.net_opt[0].count)}}
    return TD.DynTrainState.from_numpy(d, net, device=CPU)


@pytest.fixture(scope="module")
def dyn_case():
    """A 32-px moving scene, two JAX steps of the small MLP, then one
    more in each package from the carried-across state."""
    rng = np.random.default_rng(11)
    jds, jp = dynamic_setup(rng, res=32, n_times=3)
    jnet = JD.DeformationMLP(width=64, depth=3)
    init_fn, step_fn = JD.make_dynamic_train_step(_jax_cfg(), jds, jnet,
                                                  render_kwargs=JRK)
    step_fn = jax.jit(step_fn)
    state = init_fn(jp, jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        for v in (3, 7):
            state, _ = step_fn(state, jnp.int32(v))
        j2, jm = step_fn(state, jnp.int32(5))
    tds = _port_dataset(jds)
    carried = _carry_state(state, TD.DeformationMLP(width=64, depth=3))
    before = {k: p.detach().clone() for k, p in
              carried.net.named_parameters()}
    _, tstep = TD.make_dynamic_train_step(_port_cfg(jp.capacity), tds,
                                          carried.net, render_kwargs=TRK)
    t2, tm = tstep(carried, 5)
    return dict(jds=jds, tds=tds, jnet=jnet, state=state, j2=j2, jm=jm,
                carried=carried, before=before, t2=t2, tm=tm)


def _grad(mu_new, mu_old, b1=0.9):
    return (np.asarray(mu_new, np.float64)
            - b1 * np.asarray(mu_old, np.float64)) / (1 - b1)


def test_dynamic_step_matches_jax(dyn_case):
    c = dyn_case
    state, j2, jm, carried, t2, tm = (c[k] for k in (
        "state", "j2", "jm", "carried", "t2", "tm"))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]),
                               rtol=1e-5)
    assert int(tm["num_alive"]) == int(jm["num_alive"])
    for f in PARAM_FIELDS:
        g_t = _grad(t2.opt.mu[f].numpy(), carried.opt.mu[f].numpy())
        g_j = _grad(j2.opt.mu[f], state.opt.mu[f])
        np.testing.assert_array_less(np.abs(g_t - g_j),
                                     3e-4 + 1e-7 * np.abs(g_j), err_msg=f)
    np.testing.assert_array_equal(t2.dstate.count.numpy(),
                                  _np(j2.dstate.count))
    np.testing.assert_allclose(t2.dstate.grad_accum.numpy(),
                               _np(j2.dstate.grad_accum), atol=3e-4)
    np.testing.assert_allclose(t2.dstate.max_radii.numpy(),
                               _np(j2.dstate.max_radii), rtol=1e-6)
    assert t2.step == int(j2.opt.step) == 3
    # the network: its gradient read from the first moment, and its
    # update as optax makes it from JAX's own moments
    jmu = TD.flax_named(_tree_np(j2.net_opt[0].mu))
    jmu0 = TD.flax_named(_tree_np(state.net_opt[0].mu))
    jnew = TD.flax_named(_tree_np(j2.net_params))
    jold = TD.flax_named(_tree_np(state.net_params))
    assert t2.net_opt.count == int(j2.net_opt[0].count) == 3
    moved = 0.0
    for k, p in t2.net.named_parameters():
        g_t = _grad(t2.net_opt.mu[k].numpy(), carried.net_opt.mu[k].numpy())
        g_j = _grad(jmu[k], jmu0[k])
        np.testing.assert_array_less(np.abs(g_t - g_j),
                                     3e-4 + 1e-5 * np.abs(g_j), err_msg=k)
        moved = max(moved, float(np.abs(g_j).max()))
        # the port's Adam fed JAX's moments gives JAX's parameters
        named = {k: c["before"][k].clone()}
        st = TD.NetAdamState(mu={k: torch.from_numpy(jmu0[k].copy())},
                             nu={k: torch.from_numpy(TD.flax_named(
                                 _tree_np(state.net_opt[0].nu))[k].copy())},
                             count=2)
        TD.net_adam_update(named, {k: torch.from_numpy(
            g_j.astype(np.float32))}, st, 8e-4)
        np.testing.assert_allclose(named[k].numpy(), jnew[k], rtol=1e-6,
                                   atol=1e-8, err_msg=k)
        np.testing.assert_array_equal(c["before"][k].numpy(), jold[k])
        # and the port's own update stays within an Adam step of JAX's
        assert np.abs(p.detach().numpy() - jnew[k]).max() <= 2 * 8e-4
    assert moved > 0


def test_dynamic_step_on_the_tiles_route_matches_jax(dyn_case):
    """The same carried-across step through the port's ``"tiles"`` route,
    JAX's own: the loss, the gradients and the densification statistics
    (the binning the same as JAX's, so its demand too)."""
    c = dyn_case
    state, j2, jm = c["state"], c["j2"], c["jm"]
    carried = _carry_state(state, TD.DeformationMLP(width=64, depth=3))
    _, tstep = TD.make_dynamic_train_step(_port_cfg(state.params.capacity),
                                          c["tds"], carried.net,
                                          render_kwargs=JRK)
    t2, tm = tstep(carried, 5)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for f in PARAM_FIELDS:
        g_t = _grad(t2.opt.mu[f].numpy(), carried.opt.mu[f].numpy())
        g_j = _grad(j2.opt.mu[f], state.opt.mu[f])
        np.testing.assert_array_less(np.abs(g_t - g_j),
                                     3e-4 + 1e-7 * np.abs(g_j), err_msg=f)
    np.testing.assert_array_equal(t2.dstate.count.numpy(),
                                  _np(j2.dstate.count))
    np.testing.assert_allclose(t2.dstate.grad_accum.numpy(),
                               _np(j2.dstate.grad_accum), atol=3e-4)


def test_evaluate_dynamic_matches_jax(dyn_case):
    c = dyn_case
    ref = JD.evaluate_dynamic(c["j2"], c["jnet"], c["jds"], render_kwargs=JRK)
    st = _carry_state(c["j2"], TD.DeformationMLP(width=64, depth=3))
    out = TD.evaluate_dynamic(st, st.net, c["tds"], render_kwargs=TRK)
    assert out["n_views"] == ref["n_views"] == c["tds"].num_views
    np.testing.assert_allclose(out["psnr"], ref["psnr"], rtol=1e-5)
    np.testing.assert_allclose(out["ssim"], ref["ssim"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the app and the checkpoints


@pytest.mark.parametrize("model_type", ["2", "3"])
def test_dynamic_cli_end_to_end(tmp_path, model_type):
    """``tests/test_dynamic.py:122-144`` through the port: ``--model_type
    2`` (and 3) trains from a D-NeRF-layout dataset and writes the eval
    curve, the checkpoints and the canonical PLY."""
    src, out = str(tmp_path / "scene"), str(tmp_path / "out")
    os.makedirs(src)
    _write_dnerf_dataset(src, np.random.default_rng(0))
    argv = ["--source_path", src, "--model_path", out, "--model_type",
            model_type, "--iterations", "6", "--eval_every", "3",
            "--checkpoint_every", "4", "--sh_degree", "0", "--cap_max",
            "512", "--device", "cpu"]
    tr = train_app.run(argv)
    assert isinstance(tr, TD.DynamicTrainer) and tr.state.step == 6
    assert isinstance(tr.net, TD.HexPlaneField if model_type == "3"
                      else TD.DeformationMLP)
    for name in ("point_cloud.ply", "eval_curve.json", "iteration_4/state.pt",
                 "iteration_6/state.pt"):
        assert os.path.exists(os.path.join(out, name)), name
    curve = json.load(open(os.path.join(out, "eval_curve.json")))
    assert [e["step"] for e in curve] == [3, 6, 6]
    assert len(curve) >= 2 and np.isfinite(curve[-1]["psnr"])
    assert curve[-1]["n_views"] == 2
    d = CK.load_state_dict(out, 6)
    assert d["step"] == 6 and d["net_opt"]["count"] == 6


def _dyn_trainer(model_type=2, seed=0):
    rng = np.random.default_rng(seed)
    jds, jp = dynamic_setup(rng, res=32, n_times=3)
    cfg = TrainConfig(sh_degree=0, num_iters=4, model_type=model_type)
    cfg.densify.cap_max = jp.capacity
    cfg.densify.warmup_length = 1
    return TD.DynamicTrainer(cfg, _port_dataset(jds), _port_params(jp),
                             render_kwargs=TRK)


def _same_dict(a, b, path=""):
    assert type(a) is type(b) or isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_dict(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("model_type", [2, 3])
def test_dynamic_checkpoint_roundtrip(tmp_path, model_type):
    """The whole dynamic state (the network's parameters and Adam moments
    included) read back bitwise; a trainer resumed from it takes the next
    step bitwise as the one that saved it."""
    tr = _dyn_trainer(model_type)
    tr.step_once()
    tr.step_once()
    CK.save_dynamic(str(tmp_path), tr, step=2)
    saved = CK.load_state_dict(str(tmp_path), 2)
    _same_dict(saved, CK.dynamic_state_dict(tr.state, tr._np_rng,
                                            tr.instance_capacity))
    other = _dyn_trainer(model_type, seed=5)
    other.state = CK.load_dynamic(str(tmp_path), 2, other.state,
                                  other._np_rng)
    assert other.state.net is other.net
    _same_dict(CK.dynamic_state_dict(other.state, other._np_rng,
                                     other.instance_capacity), saved)
    # the same dataset for both, so that the next step must agree
    other.dataset = tr.dataset
    other._step_fn = TD.make_dynamic_train_step(
        other.cfg, tr.dataset, other.net, render_kwargs=TRK)[1]
    tr.step_once()
    other.step_once()
    _same_dict(CK.dynamic_state_dict(other.state, other._np_rng),
               CK.dynamic_state_dict(tr.state, tr._np_rng))


def test_dynamic_trainer_needs_times():
    rng = np.random.default_rng(0)
    jds, jp = dynamic_setup(rng, res=32, n_times=2)
    ds = _port_dataset(jds)
    ds.times = None
    with pytest.raises(ValueError, match="per-view times"):
        TD.DynamicTrainer(TrainConfig(model_type=2), ds, _port_params(jp))


# ---------------------------------------------------------------------------
# the compressed model


def _compressed_pair(seed=0, n=200):
    from divshot_tpu.gsio.synthetic import random_scene
    jp = random_scene(np.random.default_rng(seed), n, sh_degree=1)
    jc = JCM.init_compressed(jp, jax.random.PRNGKey(seed))
    jc = jc.replace(color_p=_randomised(jc.color_p, 1),
                    opacity_p=_randomised(jc.opacity_p, 2),
                    scalerot_p=_randomised(jc.scalerot_p, 3))
    return jp, jc


def test_compressed_decoders_match_jax(tmp_path):
    jp, jc = _compressed_pair()
    path = str(tmp_path / "c.npz")
    JCM.save_compressed(path, jc)
    tc = TCM.load_compressed(path, device=CPU)
    assert tc.latent_dim == 16 and tc.bytes_per_splat() == 28
    np.testing.assert_array_equal(tc.codes.numpy(), _np(jc.codes))
    campos = np.array([0.3, -3.0, 2.5], np.float32)
    ref = jc.decode(jnp.asarray(campos))
    out = tc.decode(torch.from_numpy(campos))
    for f in ("means", "scales", "quats", "opacity", "sh0"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   _np(getattr(ref, f)), atol=1e-5,
                                   err_msg=f)
    assert out.shN.shape == (200, 0, 3) and out.sh_degree == 0
    # the port's file read by JAX: the same keys and decode
    TCM.save_compressed(str(tmp_path / "t.npz"), tc)
    assert sorted(np.load(str(tmp_path / "t.npz")).files) == sorted(
        np.load(path).files)
    back = JCM.load_compressed(str(tmp_path / "t.npz"))
    for a, b in zip(jax.tree.leaves((back.color_p, back.opacity_p,
                                     back.scalerot_p)),
                    jax.tree.leaves((jc.color_p, jc.opacity_p,
                                     jc.scalerot_p))):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(back.codes), _np(jc.codes))


def test_quantize_ste():
    x = torch.tensor([-1.5, -0.3, 0.0, 0.004, 0.9], requires_grad=True)
    q = TCM._quantize_ste(x)
    ref = JCM._quantize_ste(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(q.detach().numpy(), _np(ref), atol=1e-7)
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones(5))


def test_distill_loss_falls_and_roundtrips(tmp_path):
    from divshot_tpu.gsio.synthetic import random_scene
    jp = random_scene(np.random.default_rng(2), 150, sh_degree=1,
                      capacity=170)
    tp = _port_params(jp)
    comp, m = TCM.distill(tp, 0, steps=60, lr=5e-3)
    losses = m["losses"]
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), (
        losses[:5], losses[-5:])
    assert comp.codes.dtype == torch.int8 and m["bytes_per_splat"] == 28
    path = str(tmp_path / "d.npz")
    TCM.save_compressed(path, comp)
    jc = JCM.load_compressed(path)
    campos = np.array([0.0, 0.5, -4.0], np.float32)
    out = comp.decode(torch.from_numpy(campos))
    ref = jc.decode(jnp.asarray(campos))
    alive = tp.alive.numpy()
    for f in ("scales", "quats", "opacity", "sh0"):
        np.testing.assert_allclose(getattr(out, f).numpy()[alive],
                                   _np(getattr(ref, f))[alive], atol=1e-5)
