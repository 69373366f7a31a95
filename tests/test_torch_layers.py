"""PyTorch port vs the JAX reference: layers, parameters and the forward
pass of the dense decoder (smoke widths, CPU).

The same numpy inputs go through ``repro`` and ``repro_torch``.  Tolerances
are fp32 with a different reduction order: atol 1e-5 for layer outputs and
1e-4 for logits, and the KV pool rows each side writes within the layer
tolerance.  The JAX side runs under ``jax.jit`` (one compile per shape,
where eager mode compiles every primitive)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_jax)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
JCFG = jax_smoke("qwen3_0_6b")
j_attention = jax.jit(JL.attention_block, static_argnums=(2,),
                      static_argnames=("paged_kernel",))
j_forward = jax.jit(JT.forward, static_argnums=(1,),
                    static_argnames=("paged_kernel",))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep torch to one intra-op thread while these tests run (the suite
    runs several workers on a shared CPU); restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("qwen3_0_6b")
    jparams = jax.jit(lambda k: JP.init_params(k, JCFG)[0])(
        jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_match_reference(which):
    """The port's copy of ModelConfig and the qwen3_0_6b registry entry
    hold the reference's field values."""
    from repro.configs import get_config as jax_full
    from repro_torch.configs import get_config
    mine, ref = ((get_config, jax_full) if which == "full"
                 else (get_smoke_config, jax_smoke))
    assert dataclasses.asdict(mine("qwen3_0_6b")) == \
        dataclasses.asdict(ref("qwen3_0_6b"))
    assert mine("qwen3-0-6b") == mine("qwen3_0_6b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32)
                               if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_rms_norm_and_swiglu():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(g), 1e-6), JL.rms_norm(x, g, 1e-6),
           LAYER_TOL)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    _close(TL.swiglu_mlp({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.swiglu_mlp(p, x), LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    cos_t, sin_t = TL.rope_angles(_t(pos), 64, theta)
    cos_j, sin_j = JL.rope_angles(pos, 64, theta)
    _close(cos_t, cos_j, LAYER_TOL)
    _close(sin_t, sin_j, LAYER_TOL)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    _close(TL.apply_rope(_t(x), cos_t, sin_t), JL.apply_rope(x, cos_j, sin_j),
           LAYER_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_multi_head_attention(window):
    """GQA attention with a causal (and windowed) mask over a ragged key
    axis."""
    rng = np.random.default_rng(2)
    B, S, T, H, KV, hd = 2, 3, 9, 4, 2, 64
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    q_pos = np.array([[6, 7, 8], [2, 3, 4]], np.int32)
    k_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mj = JL._attn_mask(q_pos, k_pos, window)
    mt = TL._attn_mask(_t(q_pos), _t(k_pos), window)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    _close(TL.multi_head_attention(_t(q), _t(k), _t(v), mt),
           JL.multi_head_attention(q, k, v, mj), LAYER_TOL)


def test_init_params_tree_matches_reference(smoke):
    """init_params builds the JAX tree's paths, shapes (stacked leading
    layer axis) and dtype."""
    cfg, jparams, _ = smoke
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in flat_j.items()}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", (tuple(v.shape),
                                          str(v.dtype).split(".")[-1])
    assert dict(walk(mine)) == want


def test_params_from_jax_carries_bf16_bits():
    """bf16 leaves (ml_dtypes arrays on the JAX side) arrive bit for bit,
    nested paths and the stacked layer axis kept."""
    w = np.random.default_rng(7).normal(size=(2, 8, 16)).astype(np.float32)
    wq_j = np.asarray(jnp.asarray(w, jnp.bfloat16))
    tparams = params_from_jax({"layers": {"attn": {"wq": wq_j}}}, "cpu")
    wq_t = tparams["layers"]["attn"]["wq"]
    assert wq_t.dtype == torch.bfloat16 and tuple(wq_t.shape) == wq_j.shape
    assert np.array_equal(wq_t.view(torch.int16).numpy(),
                          wq_j.view(np.int16))


def _layer0(tree):
    return TT.layer_params(tree, 0)


def test_attention_block_no_cache(smoke):
    cfg, jparams, tparams = smoke
    x = np.random.default_rng(3).normal(size=(2, 6, cfg.d_model)) \
        .astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    want, _ = j_attention(pj, x, JCFG)
    got, cache = TL.attention_block(_layer0(tparams["layers"])["attn"],
                                    _t(x), cfg)
    assert cache is None
    _close(got, want, LAYER_TOL)


def _paged_state(cfg, rng, B=3, P=3, n_pages=11, psz=16):
    pool = (n_pages, psz, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=pool).astype(np.float32)
    v = rng.normal(size=pool).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[:B * P] \
        .reshape(B, P).astype(np.int32)
    return k, v, bt


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("S,pos", [(1, [0, 17, 47]), (4, [0, 9, 60])])
def test_attention_block_paged(smoke, kernel, S, pos):
    """The paged branch against JAX's "xla" branch: output and the pool
    rows it writes (pos 60 wraps the 48-entry ring).  kernel="cuda" on
    CPU tensors runs the kernel's plain version."""
    cfg, jparams, tparams = smoke
    rng = np.random.default_rng(4)
    k, v, bt = _paged_state(cfg, rng)
    x = rng.normal(size=(3, S, cfg.d_model)).astype(np.float32)
    pos = np.array(pos, np.int32)
    pj = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    want, wc = j_attention(
        pj, x, JCFG,
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "block_table": jnp.asarray(bt), "pos": jnp.asarray(pos)},
        paged_kernel="xla")
    kt, vt = _t(k), _t(v)
    got, tc = TL.attention_block(
        _layer0(tparams["layers"])["attn"], _t(x), cfg,
        cache={"k": kt, "v": vt, "block_table": _t(bt), "pos": _t(pos)},
        paged_kernel=kernel)
    _close(got, want, LAYER_TOL)
    assert tc["k"] is kt and tc["v"] is vt  # updated in place
    _close(kt[1:], np.asarray(wc["k"])[1:], LAYER_TOL)
    _close(vt[1:], np.asarray(wc["v"])[1:], LAYER_TOL)
    assert tc["pos"].tolist() == np.asarray(wc["pos"]).tolist()


def test_forward_no_cache(smoke):
    cfg, jparams, tparams = smoke
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    want = j_forward(jparams, JCFG, jnp.asarray(toks))
    got = TT.forward(tparams, cfg, _t(toks))
    assert got.cache is None
    _close(got.logits, want.logits, LOGIT_TOL)


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_forward_paged_cache(smoke, kernel):
    """Two chunks through the paged cache (a 5-token block, then one
    decode token) match JAX's forward chunk by chunk, and the pools
    agree after each."""
    cfg, jparams, tparams = smoke
    rng = np.random.default_rng(6)
    L, psz, n_pages = cfg.n_layers, 16, 7
    shape = (L, n_pages, psz, cfg.n_kv_heads, cfg.head_dim)
    pools = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32)}
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jcache = {"layers": {k: jnp.asarray(v) for k, v in pools.items()}}
    tcache = {"layers": {k: _t(v) for k, v in pools.items()}}
    pos = np.array([0, 20], np.int32)
    for S in (5, 1):
        toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        want = j_forward(jparams, JCFG, jnp.asarray(toks),
                          cache=dict(jcache, pos=jnp.asarray(pos),
                                     block_table=jnp.asarray(bt)),
                          paged_kernel="xla")
        got = TT.forward(tparams, cfg, _t(toks),
                         cache=dict(tcache, pos=_t(pos),
                                    block_table=_t(bt)),
                         paged_kernel=kernel)
        _close(got.logits, want.logits, LOGIT_TOL)
        jcache = {"layers": want.cache["layers"]}
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tcache["layers"][name][:, 1:].numpy(),
                np.asarray(jcache["layers"][name])[:, 1:],
                rtol=LAYER_TOL, atol=LAYER_TOL)
        assert got.cache["pos"].tolist() == (pos + S).tolist()
        pos = pos + S
