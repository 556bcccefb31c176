"""The port's MoE slice against the reference, f32 on the CPU: the grouped
expert GEMM's plain version (`repro_torch.kernels.moe_gemm`), the MoE FFN
(`repro_torch.models.moe`), and granite-moe-3b-a800m (reduced) through
`Model.forward`, `ServingEngine.generate` and the launcher. Weights come from
the reference's `Model.init`, converted; inputs are numpy arrays from a
seed."""
import numpy as np
import pytest

from _torch_parity import (check_forward, close, jax, jnp, models, tokens,
                           torch)
from test_torch_serving import JaxGumbel, _prompts, _same

from repro.kernels.moe_gemm.moe_gemm import moe_gemm_pallas  # noqa: E402
from repro.kernels.moe_gemm.ref import moe_gemm_ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_ref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

TOL = 1e-4
GRANITE = "granite-moe-3b-a800m"
DEEPSEEK = "deepseek-v2-lite-16b"

# ---------------------------------------------------------------- the kernel

GEMM_SHAPES = [
    (4, 32, 64, 128),     # E, C, d, f: the reference's kernel-test shapes
    (8, 100, 48, 96),     # non-multiple of blocks
    (2, 8, 16, 8),        # tiny
    (3, 130, 130, 70),    # all dims ragged
]


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_version_matches_the_reference(shape, dtype):
    """Against the reference's oracle and its Pallas kernel in interpret
    mode, at the reference's own tolerances (f32 1e-5, bf16 3e-2)."""
    E, C, D, F = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = moe_gemm_ref(tx, tw)
    assert got.dtype == tdt and got.shape == (E, C, F)
    tol = 1e-5 if dtype == "float32" else 3e-2
    close(got, jref(jx, jw), tol)
    close(got, moe_gemm_pallas(jx, jw, block_c=32, block_f=32, block_d=32),
          tol)
    # the wrapper takes the plain version on CPU tensors, and counts nothing
    n0 = moe_gemm.launches
    assert torch.equal(moe_gemm(tx, tw), got)
    assert moe_gemm.launches == n0


# ---------------------------------------------------------------- the layer

def _layer(name, seed=0, **overrides):
    """(reference cfg, layer-0 MoE params), (port cfg, converted params)."""
    jm, jp, tm, tp = models(name, seed=seed, **overrides)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["moe"])
    tl = jax.tree.map(lambda a: a[0], tp["blocks"]["l0"]["moe"])
    return (jm.cfg, jl), (tm.cfg, tl)


def _x(cfg, B=2, S=9, seed=3):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _routing(cfg, jl, jx):
    """The reference's expert choice and per-expert counts, for asserting
    what a case exercises."""
    logits = np.asarray(jx.reshape(-1, cfg.d_model) @ jl["router"]["w"])
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                           cfg.moe.top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=cfg.moe.n_experts)
    return np.asarray(idx), counts


def _check_layer(j, t, jx, tx, tol=TOL):
    (jc, jl), (tc, tl) = j, t
    for jk in (False, True):                   # True: Pallas, interpret mode
        jy, jaux = jmoe.moe_forward(jl, jc, jx, use_kernel=jk)
        for tk in (False, True):               # True: the wrapper's CPU path
            ty, taux = tmoe.moe_forward(tl, tc, tx, use_kernel=tk)
            assert ty.shape == tx.shape and ty.dtype == tx.dtype
            close(ty, jy, tol)
            close(taux, jaux, tol)


@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_moe_forward_matches_the_reference(name):
    j, t = _layer(name)
    jx, tx = _x(j[0])
    _check_layer(j, t, jx, tx)
    if name == DEEPSEEK:
        assert "shared" in t[1] and t[0].moe.n_shared == 1


@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_moe_forward_with_capacity_drops(name):
    """capacity_factor 0.5: C = max(ceil(T*k/E * 0.5), k) slots, fewer
    than the busiest expert's tokens, so tokens drop; the port drops the
    same ones."""
    j, t = _layer(name, moe=dict(capacity_factor=0.5))
    jx, tx = _x(j[0], B=3, S=11)
    _, counts = _routing(j[0], j[1], jx)
    assert counts.max() > tmoe.capacity(t[0], 3 * 11)
    _check_layer(j, t, jx, tx)


@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_moe_dense_decode_branch(name):
    """``moe_dense_decode``: every expert on every token, no dispatch."""
    j, t = _layer(name, moe_dense_decode=True)
    jx, tx = _x(j[0], B=4, S=1)
    _check_layer(j, t, jx, tx)


def test_a_top_k_tie_picks_the_lower_index_as_jax_does():
    """Router weights that make experts 1 and 2 tie at the k-th (2nd)
    place for every token: the port picks expert 1, as ``jax.lax.top_k``
    does, and the pick changes the output."""
    (jc, jl), (tc, tl) = _layer(GRANITE, moe=dict(capacity_factor=2.0))
    d, E = jc.d_model, jc.moe.n_experts
    assert (E, jc.moe.top_k) == (4, 2)
    w = np.zeros((d, E), np.float32)
    w[0] = [2.0, 1.0, 1.0, 0.0]                # logits (2a, a, a, 0), a > 0
    jl = dict(jl, router={"w": jnp.asarray(w)})
    tl = dict(tl, router={"w": torch.from_numpy(w)})
    x = np.random.default_rng(5).standard_normal((2, 6, d)).astype(np.float32)
    x[..., 0] = 1.0 + np.abs(x[..., 0])
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    idx, _ = _routing(jc, jl, jx)
    assert (idx == [0, 1]).all()
    _check_layer((jc, jl), (tc, tl), jx, tx)
    # swap experts 1 and 2: the tie now routes to the other weights
    perm = [0, 2, 1, 3]
    swapped = dict(tl, **{k: tl[k][perm] for k in ("gate", "up", "down")})
    ys, _ = tmoe.moe_forward(swapped, tc, tx)
    y, _ = tmoe.moe_forward(tl, tc, tx)
    assert not torch.allclose(ys, y, atol=1e-3)


def test_capacity_is_the_reference_expression():
    from repro_torch.configs import get_config
    cfg = get_config(GRANITE)
    # decode 32 sequences, paged prefill 8 x 256, dense prefill 32 x 256
    assert [tmoe.capacity(cfg, T) for T in (32, 2048, 8192)] == \
        [8, 512, 2048]
    cfg = get_config(DEEPSEEK)
    assert [tmoe.capacity(cfg, T) for T in (32, 8192)] == [6, 960]


# ---------------------------------------------------------------- the model

B, PLEN, STEPS, BS = 2, 6, 3, 4


@pytest.fixture(scope="module")
def granite():
    jm, jp, tm, tp = models(GRANITE, seed=1)
    tk = type(tm)(tm.cfg, dtype=tm.dtype, device="cpu", use_kernel=True)
    return jm, jp, [tm, tk], tp


def test_granite_train_mode(granite):
    V = granite[0].cfg.vocab_size
    check_forward(granite, [(tokens(V, (B, 11)), None, None, None)],
                  lambda m: None, TOL)
    _, aux = granite[2][0].forward(granite[3], {"tokens": torch.from_numpy(
        tokens(V, (B, 11)))})[1:]
    assert float(aux) > 0.0                   # the MoE layers' aux loss


def _decode(V, table=None, kv_len=None):
    return [(tokens(V, (B, 1), seed=10 + i),
             np.full((B, 1), PLEN + i, np.int32), table, kv_len)
            for i in range(STEPS)]


def test_granite_prefill_then_dense_decode(granite):
    V = granite[0].cfg.vocab_size
    steps = [(tokens(V, (B, PLEN)), None, None, None)] + _decode(V)
    check_forward(granite, steps, lambda m: m.init_cache(B, PLEN + STEPS),
                  TOL)


def test_granite_prefill_then_paged_decode(granite):
    V = granite[0].cfg.vocab_size
    nb = -(-(PLEN + STEPS) // BS)
    table = np.random.default_rng(7).permutation(9)[:B * nb].reshape(
        B, nb).astype(np.int32)
    steps = [(tokens(V, (B, PLEN)), None, table[:, :-(-PLEN // BS)], None)]
    steps += _decode(V, table, PLEN + STEPS)
    check_forward(granite, steps, lambda m: m.init_paged_cache(9, BS), TOL)


@pytest.mark.parametrize("name,params", [
    (GRANITE, 3_375_072_768), (DEEPSEEK, 15_647_881_216)])
def test_full_size_parameter_counts(name, params):
    from repro.configs import get_config as jget
    from repro.models import Model as JModel
    from repro_torch.configs import get_config as tget
    from repro_torch.models import Model as TModel
    tm, jm = TModel(tget(name)), JModel(jget(name))
    assert tm.param_count() == jm.param_count() == params
    assert tm.active_param_count() == jm.active_param_count()
    assert tm.active_param_count() < params


# -------------------------------------------------------------- the serving

PAGED = dict(kv_blocks=96, kv_block_size=BS)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_granite_greedy_generate_matches_the_reference(granite, mode):
    """Each mode against the same mode of the reference: dense prefills the
    B*k tiled rows and paged the unique prompts, so T, C and the capacity
    drops differ between the modes, not between the packages."""
    jm, jp, ports, tp = granite
    kw = PAGED if mode == "paged" else {}
    prompts = _prompts(jm.cfg.vocab_size)
    jr = JEngine(jm, jp, max_new_tokens=5, temperature=0.0,
                 backend=JBackend(jm, jp, **kw)).generate(prompts, 2)
    for tm in ports:
        eng = TEngine(tm, tp, max_new_tokens=5, temperature=0.0,
                      backend=TBackend(tm, tp, **kw))
        _same(jr, eng.generate(prompts, 2))


def test_granite_paged_sampling_with_the_reference_gumbel_noise(granite):
    jm, jp, ports, tp = granite
    prompts = _prompts(jm.cfg.vocab_size, lens=(10, 10))
    key = jax.random.key(7)
    jb, tb = JBackend(jm, jp, **PAGED), TBackend(ports[0], tp, **PAGED)
    jh = jb.start_batch(prompts, 3, 4, 0.8, key)
    th = tb.start_batch(prompts, 3, 4, 0.8, JaxGumbel(key))
    while jb.decode_step(jh):
        assert tb.decode_step(th)
    assert not tb.decode_step(th)
    tr = tb.finalize(th)
    _same(jb.finalize(jh), tr)
    assert any(not np.array_equal(r.samples[0], r.samples[1]) for r in tr)


@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_granite_on_the_cpu(capsys, paged):
    from repro_torch.launch.serve import main
    argv = ["--arch", GRANITE, "--smoke", "--device", "cpu",
            "--requests", "2", "--samples", "2", "--prompt-len", "7",
            "--max-new", "3"]
    if paged:
        argv += ["--kv-blocks", "32", "--kv-block-size", "4"]
    main(argv)
    out = capsys.readouterr().out
    assert f"[model] {GRANITE}" in out and "kernels=off" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    assert ("[kv] paged cache: 32 blocks" in out) == paged


def test_profile_summary_sums_device_time_by_port_kernel():
    """`profile_serve` reports the MoE kernel's device time and share even
    when it is not among the top kernels."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from repro_torch.launch.profile_serve import profile_summary

    def ev(key, us, n):
        return NS(key=key, self_device_time_total=us, count=n,
                  device_type=DeviceType.CUDA, is_user_annotation=False)
    events = [ev("nvjet_gemm", 500.0, 10),
              ev("_ZN12_GLOBAL__N_120moe_gemm_bf16_kernelILb1EEEvPK", 300.0,
                 96),
              ev("_ZN12_GLOBAL__N_119moe_gemm_f32_kernelILb0EEEvPK", 100.0,
                 3),
              ev("flash_attention_kernel", 100.0, 1)]
    out = profile_summary(NS(key_averages=lambda: events), wall_s=0.002,
                          top=1)
    assert [k["name"] for k in out["kernels"]] == ["nvjet_gemm"]
    assert out["device_busy_share"] == pytest.approx(0.5)
    moe = out["port_kernels"]["moe_gemm"]
    assert moe["device_ms"] == pytest.approx(0.4)
    assert moe["share"] == pytest.approx(0.4) and moe["count"] == 99
    assert set(out["port_kernels"]) == {"moe_gemm", "flash_attention"}
