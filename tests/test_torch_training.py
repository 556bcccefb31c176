"""The port's training path (`repro_torch.training`, `Model.loss`,
`Model(remat=...)`, `repro_torch.launch.train`) against the reference's
(`repro.training`), on the CPU: the same weights (initialised by the
reference and converted) and the same seeded batches give the same loss,
gradients, AdamW updates and loss history, and the two packages read each
other's checkpoints."""
import json
import os
import zipfile

import numpy as np
import pytest

from _torch_parity import configs, models, to_numpy  # noqa: E402  (skips without jax / torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data import DataConfig as JDataConfig, data_iterator as jdata  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import (AdamWConfig as JAdamWConfig,  # noqa: E402
                            adamw_update as jadamw_update,
                            init_opt_state as jinit_opt_state,
                            latest_checkpoint as jlatest,
                            lr_schedule as jlr_schedule,
                            make_train_step as jmake_train_step,
                            restore_checkpoint as jrestore,
                            save_checkpoint as jsave, train as jtrain)
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, data_iterator  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import (AdamWConfig, adamw_update,  # noqa: E402
                                  init_opt_state, latest_checkpoint,
                                  lr_schedule, make_train_step,
                                  opt_state_shapes, restore_checkpoint,
                                  save_checkpoint, train)
from repro_torch.training.loop import value_and_grad  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

GRAD_TOL = 1e-4          # |port - ref| <= GRAD_TOL + GRAD_TOL * |ref|


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops run fastest on one thread (and the workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tree(np_tree, cfg):
    """A reference tree of the params' layout (params, grads, moments) as
    the port's tensors, dtypes kept."""
    return params_from_jax(np_tree, cfg, device="cpu")


def assert_tree_close(got, want, atol, rtol=0.0, what=""):
    """Two port-layout trees (tensors), leaf by leaf by path."""
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().float().numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {path}")


def lm_batch(cfg, B=2, S=16, seed=0):
    """Seeded tokens and labels (B, S[, K]) and the frontends' inputs, as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1) + tail).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        b["vision_embeds"] = (rng.standard_normal((B, 4, cfg.d_model))
                              * 0.1).astype(np.float32)
    if cfg.cross_attention:
        b["cond_memory"] = (rng.standard_normal(
            (B, cfg.n_cond_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def markov_batch(vocab=64, B=8, S=16, seed=0):
    gen = JDataConfig(vocab_size=vocab, seq_len=S, batch_size=B, seed=seed)
    return {k: np.asarray(v) for k, v in next(jdata(gen)).items()}


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=50),
    dict(lr=1e-3, warmup_steps=5, total_steps=8)])
def test_lr_schedule_equals_the_reference(cfg):
    jc, tc = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jlr_schedule(jc, s))(
        jnp.asarray(steps)))
    got = lr_schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert lr_schedule(tc, 5).dtype == torch.float32


def _adamw_case(params_np, grads_np, opt_kw, steps=2, dtype=jnp.float32):
    """``steps`` AdamW updates of both packages from the same params and
    gradients (the moments carried), returning both params and states."""
    jc, tc = JAdamWConfig(**opt_kw), AdamWConfig(**opt_kw)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32

    def both(tree):
        j = {k: jnp.asarray(a).astype(dtype) for k, a in tree.items()}
        t = {k: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdtype)
             for k, a in j.items()}
        return j, t

    jp, tp = both(params_np)
    jstate, tstate = jinit_opt_state(jp), init_opt_state(tp)
    for i in range(steps):
        jg, tg = both({k: a * (i + 1) for k, a in grads_np.items()})
        jp, jstate, jm = jadamw_update(jc, jp, jg, jstate)
        tp, tstate, tm = adamw_update(tc, tp, tg, tstate)
        # the norm sums in another order: f32 rounding over the leaves
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    return jp, jstate, tp, tstate


def test_adamw_with_clipping_equals_the_reference():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal((16,)).astype(np.float32)}
    grads = {"w": 50 * rng.standard_normal((8, 16)).astype(np.float32),
             "b": 50 * rng.standard_normal((16,)).astype(np.float32)}
    jp, js, tp, ts = _adamw_case(params, grads, dict(lr=1e-2, grad_clip=1.0,
                                                     warmup_steps=1))
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
        for mom in ("m", "v"):
            np.testing.assert_allclose(ts[mom][k].numpy(),
                                       np.asarray(js[mom][k]), atol=1e-6,
                                       rtol=1e-6)


def test_adamw_decays_a_stacked_norm_scale_as_stored():
    """A stacked (n_super_blocks, d) norm scale has ndim 2 as stored and is
    decayed in the reference; a (d,) scale is not."""
    rng = np.random.default_rng(1)
    params = {"stacked_scale": np.ones((3, 16), np.float32),
              "scale": np.ones((16,), np.float32)}
    grads = {k: np.zeros_like(v) for k, v in params.items()}
    grads["stacked_scale"][:, 0] = rng.standard_normal(3)
    kw = dict(lr=1e-1, weight_decay=0.5, warmup_steps=1)
    jp, _, tp, _ = _adamw_case(params, grads, kw)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    # decay moved the untouched entries of the stacked scale only
    assert (tp["stacked_scale"][:, 1:] < 1).all()
    assert (tp["scale"] == 1).all()


def test_adamw_on_bf16_params_within_one_ulp():
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((2, 32, 64)).astype(np.float32),
              "s": rng.standard_normal((64,)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    jp, js, tp, ts = _adamw_case(params, grads, dict(lr=1e-2, warmup_steps=1),
                                 steps=3, dtype=jnp.bfloat16)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        assert ts["m"][k].dtype == ts["v"][k].dtype == torch.float32
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        # bf16 keeps 8 significant bits: an ulp is 2^(exponent - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all(), k


def test_opt_state_shapes_mirror_the_params():
    model = Model(configs("fixture")[1], dtype=torch.float32, device="cpu")
    shapes = opt_state_shapes(model.param_shapes())
    state = init_opt_state(model.init(torch.Generator().manual_seed(0)))
    assert [tuple(s) for _, s in flatten(shapes)] == \
        [tuple(t.shape) for _, t in flatten(state)]
    assert all(t.dtype == torch.float32 for _, t in flatten(state["m"]))
    assert state["step"].dtype == torch.int32


# ------------------------------------------------------------------ Model.loss

@pytest.mark.parametrize("name", ["fixture"] + ASSIGNED_ARCHS)
def test_loss_and_gradients_equal_the_reference(name):
    jm, jp, tm, tp = models(name)
    b = lm_batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, as_jax(b))
    tl, tg = value_and_grad(tm.loss, tp, as_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = port_tree(to_numpy(jg), tm.cfg)
    got = dict(flatten(tg))
    for path, w in flatten(want):
        np.testing.assert_allclose(got[path].numpy(), w.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{name} {path}")
    if tm.cfg.moe is not None:        # the aux loss is part of the loss
        _, _, ja = jm.forward(jp, as_jax(b))
        _, _, ta = tm.forward(tp, as_torch(b))
        assert float(ja) > 0
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_moe_capacity_drops_and_router_gradient_equal_the_reference(
        monkeypatch):
    """At capacity factor 0.5 granite's experts drop tokens; the port drops
    the reference's tokens: the same loss, aux loss and router gradient."""
    from repro_torch.models import moe as moe_mod
    seen = []
    aux_loss = moe_mod._aux_loss

    def record(cfg, probs, expert_idx):
        seen.append((cfg, expert_idx.detach().clone()))
        return aux_loss(cfg, probs, expert_idx)

    monkeypatch.setattr(moe_mod, "_aux_loss", record)
    jm, jp, tm, tp = models("granite-moe-3b-a800m",
                            moe=dict(capacity_factor=0.5))
    b = lm_batch(tm.cfg, B=2, S=32, seed=4)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, as_jax(b))
    tl, tg = value_and_grad(tm.loss, tp, as_torch(b))
    drops = 0
    for cfg, idx in seen:
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
        drops += int((counts - moe_mod.capacity(cfg, idx.shape[0])).clamp_min(
            0).sum())
    assert drops > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(flatten(port_tree(to_numpy(jg), tm.cfg)))
    got = dict(flatten(tg))
    routers = [p for p in want if p.endswith("moe/router/w")]
    assert routers
    for path in routers:
        assert float(want[path].abs().max()) > 0
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_remat_equals_no_remat():
    _, _, tm, tp = models("granite-moe-3b-a800m")
    b = as_torch(lm_batch(tm.cfg))
    l0, g0 = value_and_grad(tm.loss, tp, b)
    tr = Model(tm.cfg, dtype=torch.float32, device="cpu", remat=True)
    l1, g1 = value_and_grad(tr.loss, tp, b)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    assert_tree_close(g1, g0, atol=1e-5, rtol=1e-5, what="remat")


# ------------------------------------------------------------------ train step

def _steps(microbatches):
    """One f32 train step of each package on the fixture from the same
    params and markov batch."""
    jm, jp, tm, tp = models("fixture")
    b = markov_batch()
    jopt = JAdamWConfig(lr=1e-3)
    jstep = jax.jit(jmake_train_step(jm, jopt, microbatches=microbatches))
    jp2, js2, jmet = jstep(jp, jinit_opt_state(jp), as_jax(b))
    tstep = make_train_step(tm, AdamWConfig(lr=1e-3),
                            microbatches=microbatches)
    tp2, ts2, tmet = tstep(tp, init_opt_state(tp), as_torch(b))
    return tm, (jp2, js2, jmet), (tp2, ts2, tmet)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_equals_the_reference(microbatches):
    tm, (jp, js, jm), (tp, ts, tmet) = _steps(microbatches)
    np.testing.assert_allclose(float(tmet["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tmet["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 1
    assert_tree_close(tp, port_tree(to_numpy(jp), tm.cfg), atol=2e-4,
                      what="params")
    for mom in ("m", "v"):
        assert_tree_close(ts[mom], port_tree(to_numpy(js[mom]), tm.cfg),
                          atol=1e-5, rtol=1e-4, what=mom)


def test_microbatches_equal_the_full_batch():
    """The reference's own invariant (tests/test_training_data.py) held in
    the port: loss within 1e-5 relative, params within 2e-4."""
    _, _, tm, tp1 = models("fixture")
    _, _, _, tp4 = models("fixture")
    b = as_torch(markov_batch())
    s1 = make_train_step(tm, AdamWConfig(lr=1e-3))
    s4 = make_train_step(tm, AdamWConfig(lr=1e-3), microbatches=4)
    p1, _, m1 = s1(tp1, init_opt_state(tp1), b)
    p4, _, m4 = s4(tp4, init_opt_state(tp4), b)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    assert_tree_close(p4, p1, atol=2e-4, rtol=2e-4, what="microbatches")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, AdamWConfig(), microbatches=3)(
            p1, init_opt_state(p1), b)


def test_train_history_equals_the_reference():
    jm, jp, tm, tp = models("fixture")
    kw = dict(vocab_size=64, seq_len=16, batch_size=8, seed=2)
    opt = dict(lr=2e-3, warmup_steps=3, total_steps=10)
    _, jinfo = jtrain(jm, JAdamWConfig(**opt), jdata(JDataConfig(**kw)), 10,
                      params=jp, log_every=1)
    _, tinfo = train(tm, AdamWConfig(**opt),
                     data_iterator(DataConfig(**kw), device="cpu"), 10,
                     params=tp, log_every=1)
    jh, th = jinfo["history"], tinfo["history"]
    assert len(th) == len(jh) == 10
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    assert tinfo["final_loss"] == th[-1]["loss"]


def test_loss_decreases_on_markov():
    """The reference's `test_loss_decreases_on_markov`, in the port."""
    tm = Model(configs("fixture")[1], dtype=torch.float32, device="cpu")
    dc = DataConfig(vocab_size=64, seq_len=32, batch_size=16, kind="markov")
    _, info = train(tm, AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=80),
                    data_iterator(dc, device="cpu"), 80,
                    generator=torch.Generator().manual_seed(0))
    h = info["history"]
    assert h[-1]["loss"] < h[0]["loss"] * 0.97


def test_a_bf16_step_keeps_every_dtype():
    """A bf16 mamba2 step: bf16 leaves stay bf16, the SSM's ``A_log``,
    ``dt_bias`` and ``D`` stay f32 (as the reference keeps them), and every
    moment is f32."""
    from repro_torch.models.ssm import F32_KEYS
    cfg = get_config("mamba2-370m").reduced()
    tm = Model(cfg, dtype=torch.bfloat16, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    dtypes = {p: t.dtype for p, t in flatten(tp)}
    assert {dt for p, dt in dtypes.items()
            if p.split("/")[-1] in F32_KEYS} == {torch.float32}
    b = as_torch(lm_batch(cfg, B=2, S=8))
    tp, ts, m = make_train_step(tm, AdamWConfig(lr=1e-3))(
        tp, init_opt_state(tp), b)
    assert np.isfinite(float(m["loss"]))
    assert {p: t.dtype for p, t in flatten(tp)} == dtypes
    assert {t.dtype for mom in ("m", "v")
            for _, t in flatten(ts[mom])} == {torch.float32}


def test_a_kernel_model_is_refused():
    tm = Model(configs("fixture")[1], dtype=torch.float32, device="cpu",
               use_kernel=True)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(tm, AdamWConfig())
    with pytest.raises(ValueError, match="no backward"):
        train(tm, AdamWConfig(), iter(()), 1,
              generator=torch.Generator().manual_seed(0))


def test_checkpoint_fn_sees_every_nth_step():
    tm = Model(configs("fixture")[1], dtype=torch.float32, device="cpu")
    seen = []
    train(tm, AdamWConfig(), data_iterator(DataConfig(64, 8, 2),
                                           device="cpu"), 5,
          generator=torch.Generator().manual_seed(0), checkpoint_every=2,
          checkpoint_fn=lambda step, p, o: seen.append(
              (step, int(o["step"]))))
    assert seen == [(2, 2), (4, 4)]


# ------------------------------------------------------------------ checkpoints

def _members(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_are_the_references_byte_for_byte(tmp_path, dtype):
    """The same params and state saved by each package: equal manifests and
    equal ``.npy`` members, bf16 raw bits included."""
    jc, tc = configs("fixture")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = JModel(jc, dtype=jdt).init(jax.random.key(3))
    tp = params_from_jax(to_numpy(jp), tc, device="cpu",
                         dtype=getattr(torch, dtype))
    a = jsave(str(tmp_path / "ref"), 3, jp, jinit_opt_state(jp))
    b = save_checkpoint(str(tmp_path / "port"), 3, tp, init_opt_state(tp))
    assert os.path.basename(a) == os.path.basename(b) == "step_00000003"
    assert _manifest(b) == _manifest(a)
    assert _members(b) == _members(a)


def test_the_reference_reads_the_ports_f32_checkpoint(tmp_path):
    jm, jp, tm, tp = models("fixture", seed=5)
    state = init_opt_state(tp)
    tstep = make_train_step(tm, AdamWConfig(lr=1e-3))
    tp, state, _ = tstep(tp, state, as_torch(markov_batch()))
    path = save_checkpoint(str(tmp_path), 1, tp, state)
    step, jp2, js2 = jrestore(path, jm.param_specs(),
                              opt_template=jinit_opt_state(jp))
    assert step == 1
    for got, want in ((jp2, tp), (js2["m"], state["m"]),
                      (js2["v"], state["v"])):
        got = dict(flatten(port_tree(to_numpy(got), tm.cfg)))
        for p, w in flatten(want):
            assert torch.equal(got[p], w), p
    assert int(js2["step"]) == 1


def test_the_port_reads_the_references_f32_checkpoint(tmp_path):
    jm, jp, tm, tp = models("fixture", seed=6)
    jstate = jinit_opt_state(jp)
    jp, jstate, _ = jax.jit(jmake_train_step(jm, JAdamWConfig(lr=1e-3)))(
        jp, jstate, as_jax(markov_batch()))
    path = jsave(str(tmp_path), 1, jp, jstate)
    want_p = port_tree(to_numpy(jp), tm.cfg)
    want_m = port_tree(to_numpy(jstate["m"]), tm.cfg)
    # tensor templates and shape templates alike
    for ptemp, otemp in (
            (tp, init_opt_state(tp)),
            (tm.param_shapes(), opt_state_shapes(tm.param_shapes()))):
        step, p2, s2 = restore_checkpoint(path, ptemp, otemp, device="cpu")
        assert step == 1
        for got, want in ((p2, want_p), (s2["m"], want_m)):
            got = dict(flatten(got))
            for path_, w in flatten(want):
                assert got[path_].dtype == torch.float32
                assert torch.equal(got[path_], w), path_
        assert s2["step"].dtype == torch.int32 and int(s2["step"]) == 1


def test_f11_the_port_restores_a_bf16_checkpoint_the_reference_cannot(
        tmp_path):
    """F11: the reference's restore raises on its own bf16 checkpoint (a
    ``|V2`` array); the port restores it bit-exact."""
    jc, tc = configs("fixture")
    jm = JModel(jc, dtype=jnp.bfloat16)
    jp = jm.init(jax.random.key(7))
    path = jsave(str(tmp_path), 9, jp)
    with pytest.raises(TypeError):
        jrestore(path, jm.param_specs())
    tm = Model(tc, dtype=torch.bfloat16, device="cpu")
    want = params_from_jax(to_numpy(jp), tc, device="cpu",
                           dtype=torch.bfloat16)
    for template in (tm.param_shapes(),
                     tm.init(torch.Generator().manual_seed(0))):
        step, got, _ = restore_checkpoint(path, template, device="cpu")
        assert step == 9
        got = dict(flatten(got))
        for p, w in flatten(want):
            assert got[p].dtype == torch.bfloat16
            assert torch.equal(got[p].view(torch.int16),
                               w.view(torch.int16)), p


def test_a_shape_mismatch_is_refused(tmp_path):
    _, tc = configs("fixture")
    tp = Model(tc, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), 1, tp)
    other = Model(tc.with_overrides(d_model=128), dtype=torch.float32,
                  device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        restore_checkpoint(path, other.param_shapes(), device="cpu")
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path), 1, tp)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_latest_checkpoint_behaves_as_the_references(tmp_path):
    tp = {"w": torch.ones(2, 2)}
    root = str(tmp_path / "ck")
    assert latest_checkpoint(root) is None and jlatest(root) is None
    os.makedirs(root)
    assert latest_checkpoint(root) is None and jlatest(root) is None
    for step in (3, 12, 7):
        save_checkpoint(root, step, tp)
    assert latest_checkpoint(root) == jlatest(root) == os.path.join(
        root, "step_00000012")


# ------------------------------------------------------------------ launcher

@pytest.mark.parametrize("arch", ["chatglm3-6b", "musicgen-medium"])
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
          "--batch", "2", "--seq", "16", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["0", "2"]
    assert all(np.isfinite(float(s.split()[3])) for s in steps)
    path = out[-1].split("checkpoint: ")[1]
    tm = Model(get_config(arch).reduced(), dtype=torch.float32, device="cpu")
    step, params, _ = restore_checkpoint(path, tm.param_shapes(),
                                         device="cpu")
    assert step == 3
    assert all(torch.isfinite(t).all() for _, t in flatten(params))


def test_launcher_refuses_a_mesh_and_a_missing_card():
    """A production mesh needs its ranks started for it, and a world of
    ranks on ``cuda`` needs its cards: both exit naming the counts (the
    sharded runs themselves: tests/test_torch_sharded_train.py)."""
    from repro_torch.launch.train import main
    for mesh, ranks in (("single", "256"), ("multi", "512")):
        with pytest.raises(SystemExit) as exc:
            main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                  "--mesh", mesh])
        assert exc.value.code not in (0, None)
        assert f"needs {ranks} ranks" in str(exc.value.code)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main(["--arch", "chatglm3-6b", "--smoke", "--mesh", "debug"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "chatglm3-6b", "--smoke", "--steps", "1"])
