"""The remaining arch features of the port against the reference, f32 on
the CPU, same weights (initialised by the reference and converted) and
inputs from a seed: the sliding-window ring cache, M-RoPE with vision
embeddings (qwen2-vl-7b), and cross-attention to a conditioning memory with
multi-codebook tokens (musicgen-medium), with and without the cross K/V
cache.

* ``tests/test_decode_equivalence.py``'s six ``CASES`` (the window among
  them) and its beyond-window ring: the port's prefill and decode logits
  against the reference's (1e-4), and inside the port each decode step
  against the full forward (the reference's 1e-3).
* ``tests/test_arch_smoke.py``'s reduced forward over every assigned arch
  and its reduced decode step over five: logits against the reference's
  (1e-4), not merely finite.
* ``tests/test_decode_optimizations.py``'s cross K/V cache: cached against
  recomputed inside the port (1e-5), each against the reference's (1e-4).

The port runs with its kernels off and on (on CPU tensors the kernel
wrappers take their plain versions)."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import close, configs, jax, jnp, to_numpy, torch

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from test_decode_equivalence import CASES  # noqa: E402

TOL = 1e-4
FULL_TOL = 1e-3             # decode against the full forward, as the reference
KERNEL = [False, True]
DECODE_ARCHS = ["deepseek-v2-lite-16b", "chatglm3-6b", "qwen2-vl-7b",
                "musicgen-medium", "granite-moe-3b-a800m"]


def port_config(jc):
    """The port's `ArchConfig` of a reference config, nested configs
    included."""
    kw = {}
    for f in dataclasses.fields(jc):
        v = getattr(jc, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconfig.ArchConfig(**kw)


_PAIRS = {}


def pair(jc, tc, seed: int = 0):
    """(reference model, params, {use_kernel: port model}, port params) on
    the reference's weights, made once per config."""
    key = (jc, seed)
    if key not in _PAIRS:
        jm = JModel(jc, dtype=jnp.float32)
        jp = jm.init(jax.random.key(seed))
        ports = {k: TModel(tc, dtype=torch.float32, device="cpu",
                           use_kernel=k) for k in KERNEL}
        _PAIRS[key] = (jm, jp, ports,
                       params_from_jax(to_numpy(jp), tc, device="cpu"))
    return _PAIRS[key]


def _tokens(cfg, shape, seed):
    if cfg.n_codebooks > 1:
        shape = tuple(shape) + (cfg.n_codebooks,)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _extras(cfg, B, seed, n_mem=8):
    """The frontends' stub inputs, random from ``seed``: 4 vision
    embeddings, or ``n_mem`` rows of conditioning memory."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision":
        out["vision_embeds"] = (rng.standard_normal((B, 4, cfg.d_model))
                                * 0.1).astype(np.float32)
    if cfg.cross_attention:
        out["cond_memory"] = (rng.standard_normal((B, n_mem, cfg.d_model))
                              * 0.1).astype(np.float32)
    return out


def _batches(batch):
    """The same numpy batch for the reference and for the port."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def _positions(cfg, B, pos):
    p = np.full((B, 1), pos, np.int32)
    if cfg.mrope_sections:
        p = np.broadcast_to(p[..., None], (B, 1, 3)).copy()
    return p


_REF = {}


def _steps(tc, B, S, steps, seed, extras):
    """The numpy batches of a prefill of ``S`` tokens and ``steps`` decode
    steps, each decode step with the conditioning memory if there is
    one."""
    out = [{"tokens": _tokens(tc, (B, S), seed), **extras}]
    for step in range(steps):
        b = {"tokens": _tokens(tc, (B, 1), 100 * seed + step),
             "positions": _positions(tc, B, S + step)}
        if "cond_memory" in extras:
            b["cond_memory"] = extras["cond_memory"]
        out.append(b)
    return out


def _reference(jc, key, batches, cache_len):
    """The reference's logits for each of ``batches`` in turn over one
    cache of ``cache_len``, run once per ``key``."""
    if key not in _REF:
        jm, jp, _, _ = pair(jc, None)
        cache = jm.init_cache(batches[0]["tokens"].shape[0], cache_len)
        out = []
        for b in batches:
            logits, cache, _ = jm.forward(jp, _batches(b)[0], cache)
            out.append(np.asarray(logits))
        _REF[key] = out
    return _REF[key]


def _prefill_and_decode(jc, tc, use_kernel, B, S, steps, seed=1,
                        cache_len=None, full=True, extras=None):
    """Prefill ``S`` tokens and decode ``steps`` more through both
    packages: prefill and decode logits held to the reference's; with
    ``full``, each port decode step held to the port's full forward over
    the whole sequence. Returns the port's cache."""
    _, _, ports, tp = pair(jc, tc)
    tm = ports[use_kernel]
    extras = extras or {}
    cache_len = cache_len or S + steps
    batches = _steps(tc, B, S, steps, seed, extras)
    ref = _reference(jc, (jc, B, S, steps, seed, cache_len, tuple(extras)),
                     batches, cache_len)
    cache = tm.init_cache(B, cache_len)
    cur = batches[0]["tokens"]
    for i, (b, jl) in enumerate(zip(batches, ref)):
        tl, out, _ = tm.forward(tp, _batches(b)[1], cache)
        assert out is cache and tuple(tl.shape) == jl.shape
        close(tl, jl, TOL)
        if i == 0 or not full:
            continue
        cur = np.concatenate([cur, b["tokens"]], axis=1)
        tf, _, _ = tm.forward(tp, _batches({"tokens": cur, **extras})[1])
        np.testing.assert_allclose(tl[:, 0].numpy(), tf[:, -1].numpy(),
                                   rtol=FULL_TOL, atol=FULL_TOL,
                                   err_msg=f"step {i}")
    return cache


# ------------------------------------------------------------------ the CASES

@pytest.mark.parametrize("use_kernel", KERNEL, ids=["plain", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_the_reference_and_the_full_forward(case, use_kernel):
    jc = CASES[case]
    _prefill_and_decode(jc, port_config(jc), use_kernel, B=2, S=16, steps=3)


@pytest.mark.parametrize("use_kernel", KERNEL, ids=["plain", "kernel"])
def test_windowed_decode_beyond_the_window(use_kernel):
    """The ring: 12 prompt tokens and 6 decode steps over a window of 8
    slots, each step's logits the reference's and the windowed full
    forward's (tokens outside the window invisible)."""
    jc = CASES["window"]
    cache = _prefill_and_decode(jc, port_config(jc), use_kernel, B=1, S=12,
                                steps=6, seed=2, cache_len=18)
    assert cache["blocks"]["l0"]["k"].shape[2] == 8     # ring = window slots
    # every slot rewritten since the prefill: positions 10 .. 17
    assert sorted(cache["blocks"]["l0"]["pos"][0, 0].tolist()) == \
        list(range(10, 18))


# ---------------------------------------------------------------- arch level

@pytest.mark.parametrize("use_kernel", KERNEL, ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_reduced_forward_matches_the_reference(arch, use_kernel):
    jc, tc = configs(arch)
    jm, jp, ports, tp = pair(jc, tc)
    B, S = 2, 16
    batch = {"tokens": _tokens(tc, (B, S), 3), **_extras(tc, B, 4)}
    jb, tb = _batches(batch)
    if (jc, "train") not in _REF:
        _REF[jc, "train"] = jm.forward(jp, jb)
    jl, _, ja = _REF[jc, "train"]
    tl, _, ta = ports[use_kernel].forward(tp, tb)
    want = (B, S, tc.n_codebooks, tc.padded_vocab) if tc.n_codebooks > 1 \
        else (B, S, tc.padded_vocab)
    assert tl.shape == jl.shape == want
    close(tl, jl, TOL)
    close(ta, ja, TOL)


@pytest.mark.parametrize("use_kernel", KERNEL, ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_reduced_decode_step_matches_the_reference(arch, use_kernel):
    """Prefill then one decode token, as ``test_reduced_decode_step``
    (MoE capacity 8.0: no token drops)."""
    over = {"moe": dict(capacity_factor=8.0)} \
        if get_config(arch).moe is not None else {}
    jc, tc = configs(arch, **over)
    _prefill_and_decode(jc, tc, use_kernel, B=2, S=16, steps=1, seed=5,
                        cache_len=20, full=False,
                        extras=_extras(tc, 2, 6))


@pytest.mark.parametrize("use_kernel", KERNEL, ids=["plain", "kernel"])
def test_vision_embeds_and_mrope_decode_against_the_full_forward(use_kernel):
    """qwen2-vl-7b reduced: vision embeddings replace the first 4 prompt
    positions, M-RoPE's three sections rotate alike; three decode steps
    give the full forward's logits."""
    jc, tc = configs("qwen2-vl-7b")
    assert tc.mrope_sections == (8, 12, 12)
    _prefill_and_decode(jc, tc, use_kernel, B=2, S=12, steps=3, seed=7,
                        extras=_extras(tc, 2, 8))


# ------------------------------------------------ cross-attention K/V cache

def test_cross_kv_cache_decode_matches_recompute():
    """The reference's config: 2 layers, 4 codebooks, 8 memory rows against
    the default 64 (the reference's prefill resizes the cross K/V entries
    to the memory; the port's caller sizes the cache to it). The cached
    variant decodes without the memory. One set of weights: the cached
    model's params are the uncached one's."""
    from repro.models import ArchConfig as JArchConfig
    base = dict(name="a", arch_type="audio", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=33,
                mlp_variant="gelu", rope_variant="sinusoidal", n_codebooks=4,
                cross_attention=True, frontend="audio")
    jcs = [JArchConfig(**base), JArchConfig(**base, cross_kv_cache=True)]
    tcs = [port_config(c) for c in jcs]
    jm0, jp, _, tp = pair(jcs[0], tcs[0])
    jms = [jm0, JModel(jcs[1], dtype=jnp.float32)]
    B, S = 2, 12
    mem = (np.random.default_rng(10).standard_normal((B, 8, 64))
           * 0.1).astype(np.float32)
    runs = [[{"tokens": _tokens(tcs[0], (B, S), 9), "cond_memory": mem}]
            for _ in range(2)]
    for step in range(3):
        nt = _tokens(tcs[0], (B, 1), 20 + step)
        pos = np.full((B, 1), S + step, np.int32)
        runs[0].append({"tokens": nt, "positions": pos, "cond_memory": mem})
        runs[1].append({"tokens": nt, "positions": pos})
    ref, ref_xk = [], None
    for jm, steps in zip(jms, runs):
        cache, out = jm.init_cache(B, S + 4), []
        for b in steps:
            logits, cache, _ = jm.forward(jp, _batches(b)[0], cache)
            out.append(logits)
        ref.append(out)
    ref_xk = cache["blocks"]["l0"]["xk"]
    for use_kernel in KERNEL:
        got, caches = [], []
        for tc, steps in zip(tcs, runs):
            tm = TModel(tc, dtype=torch.float32, device="cpu",
                        use_kernel=use_kernel)
            cache, out = tm.init_cache(B, S + 4, cond_len=8), []
            caches.append(cache)
            for b in steps:
                out.append(tm.forward(tp, _batches(b)[1], cache)[0])
            got.append(out)
        assert "xk" not in caches[0]["blocks"]["l0"]
        assert caches[1]["blocks"]["l0"]["xk"].shape == (2, B, 8, 4, 16)
        close(caches[1]["blocks"]["l0"]["xk"], ref_xk, TOL)
        for i in range(1, 4):           # the decode steps
            np.testing.assert_allclose(got[1][i].numpy(), got[0][i].numpy(),
                                       rtol=1e-5, atol=1e-5)
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                close(a, b, TOL)
    # the cache starts at the config's memory length
    assert TModel(tcs[1], dtype=torch.float32, device="cpu").init_cache(
        B, S)["blocks"]["l0"]["xk"].shape == (2, B, 64, 4, 16)


def test_a_cross_kv_cache_sized_to_the_memory_keeps_its_tensors():
    """A cache whose cross K/V entries have the memory's length is filled
    in place by the prefill (a decode graph addresses its tensors); the
    prefill's K/V are the memory's projections."""
    jc, tc = configs("musicgen-medium", cross_kv_cache=True)
    _, _, ports, tp = pair(jc, tc)
    tm = ports[False]
    B = 2
    mem = _extras(tc, B, 11, n_mem=tc.n_cond_tokens)["cond_memory"]
    cache = tm.init_cache(B, 20)
    xk = cache["blocks"]["l0"]["xk"]
    _, tb = _batches({"tokens": _tokens(tc, (B, 9), 12), "cond_memory": mem})
    tm.forward(tp, tb, cache)
    assert cache["blocks"]["l0"]["xk"] is xk
    wk = tp["blocks"]["l0"]["cross"]["wk"]["w"][0]
    want = (torch.from_numpy(mem) @ wk).reshape(B, tc.n_cond_tokens,
                                                tc.n_heads, tc.hd)
    close(xk[0], want, 1e-6)


def test_musicgen_initialises_forwards_and_counts_on_the_port():
    """`Model.init` draws the cross-attention and multi-codebook leaves;
    the forward runs on its own weights; the parameter count is the
    reference's (tests/test_torch_convert.py counts every arch)."""
    cfg = get_config("musicgen-medium").reduced()
    tm = TModel(cfg, dtype=torch.float32, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    blk = params["blocks"]["l0"]
    assert set(blk) == {"ln1", "attn", "ln_x", "cross", "ln2", "mlp"}
    assert params["embed"]["table"].shape == (4, cfg.padded_vocab,
                                              cfg.d_model)
    assert params["lm_head"]["w"].shape == (4, cfg.d_model,
                                            cfg.padded_vocab)
    toks = torch.from_numpy(_tokens(cfg, (1, 5), 0))
    mem = torch.from_numpy(_extras(cfg, 1, 1)["cond_memory"])
    logits, _, _ = tm.forward(params, {"tokens": toks, "cond_memory": mem})
    assert logits.shape == (1, 5, 4, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
