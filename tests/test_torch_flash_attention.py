"""PyTorch port vs the JAX reference: flash attention and the no-cache
attention routes (CPU, small shapes).

The port's ``flash_attention`` runs its plain version on CPU tensors; it
is held against JAX's Pallas kernel in interpret mode at the tolerances
of the reference's own kernel test (tests/test_kernels.py: fp32 2e-6,
bf16 2e-2, atol five times that), against JAX's ``reference_attention``
at a ragged S (which the reference kernel does not take), and through
``attention_block`` against JAX's ``use_pallas`` and ``attention_impl=
"chunked"`` routes at fp32 layer tolerance (1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_attention import ops as j_fa  # noqa: E402
from repro.kernels.flash_attention import ref as j_fa_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402

LAYER_TOL = 1e-5
j_attention = jax.jit(JL.attention_block, static_argnums=(2,),
                      static_argnames=("use_pallas",))
j_reference = jax.jit(j_fa_ref.reference_attention,
                      static_argnames=("window", "chunk"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,S,H,KV,hd,window,chunk,dtype", [
    (2, 128, 4, 2, 64, 0, 0, "float32"),
    (1, 128, 4, 1, 80, 0, 0, "float32"),      # zamba2's head_dim, GQA 4
    (1, 256, 2, 1, 64, 64, 0, "float32"),     # sliding window
    (1, 256, 2, 2, 64, 0, 64, "float32"),     # chunked-local mask
    (2, 128, 4, 2, 128, 0, 0, "bfloat16"),
    (1, 256, 4, 2, 80, 32, 0, "bfloat16"),
])
def test_flash_attention_matches_jax_kernel(B, S, H, KV, hd, window, chunk,
                                            dtype):
    """The wrapper (plain version on the CPU) against the reference's
    Pallas kernel in interpret mode, GQA unexpanded on the port's side."""
    q, k, v = _qkv(B * S + hd, B, S, H, KV, hd)
    jdt = jnp.dtype(dtype)
    want = j_fa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                window=window, chunk=chunk)
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(a, jdt)
                                              .astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for a in (q, k, v))
    n = fa.flash_attention.launches
    got = fa.flash_attention(tq, tk, tv, window=window, chunk=chunk)
    assert fa.flash_attention.launches == n  # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-6 if dtype == "float32" else 2e-2
    _close(got, want.astype(jnp.float32), tol, 5 * tol)


@pytest.mark.parametrize("S,window,chunk", [(100, 0, 0), (77, 16, 0),
                                            (90, 0, 32)])
def test_flash_attention_ragged_s_matches_reference(S, window, chunk):
    """A ragged S (the reference kernel asserts S % 128 == 0 above 128)
    against JAX's ``reference_attention`` on the repeated K/V heads."""
    B, H, KV, hd = 2, 4, 2, 64
    q, k, v = _qkv(S, B, S, H, KV, hd)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    want = jnp.transpose(j_reference(
        tr(q), jnp.repeat(tr(k), H // KV, 1), jnp.repeat(tr(v), H // KV, 1),
        window=window, chunk=chunk), (0, 2, 1, 3))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             window=window, chunk=chunk)
    _close(got, want, 2e-6, 1e-5)


def test_flash_attention_validates():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):      # H not a multiple of KV
        fa.flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3,
                                                                      64))
    with pytest.raises(ValueError):      # k/v of another sequence length
        fa.flash_attention(q, torch.zeros(1, 7, 2, 64), torch.zeros(1, 7, 2,
                                                                      64))
    with pytest.raises(ValueError):      # a negative window
        fa.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError):      # a device that is neither
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.fixture(scope="module")
def smoke():
    """Smoke qwen3_0_6b's attention weights (qk-norm, GQA 2), drawn with
    numpy at the reference's scales."""
    jcfg = jax_smoke("qwen3_0_6b")
    D, qd, kvd, hd = jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, jcfg.head_dim
    rng = np.random.default_rng(0)

    def f(*shape):
        return (rng.normal(size=shape) / np.sqrt(D)).astype(np.float32)
    attn = {"wq": f(D, qd), "wk": f(D, kvd), "wv": f(D, kvd),
            "wo": f(qd, D), "q_norm": np.ones(hd, np.float32),
            "k_norm": np.ones(hd, np.float32)}
    return jcfg, attn, params_from_jax(attn, "cpu")


@pytest.mark.parametrize("kernel,use_pallas", [("cuda", True),
                                               ("torch", False)])
def test_attention_block_no_cache_routes(smoke, kernel, use_pallas):
    """attention_block's no-cache branch: kernel="cuda" (the flash
    kernel's route; its plain version on the CPU) against JAX's
    use_pallas=True, kernel="torch" against use_pallas=False."""
    jcfg, jattn, tattn = smoke
    cfg = get_smoke_config("qwen3_0_6b")
    x = np.random.default_rng(3).normal(size=(2, 128, cfg.d_model)) \
        .astype(np.float32)
    want, _ = j_attention(jattn, x, jcfg, use_pallas=use_pallas)
    got, cache = TL.attention_block(tattn, torch.from_numpy(x), cfg,
                                    kernel=kernel)
    assert cache is None
    _close(got, want, LAYER_TOL, LAYER_TOL)


@pytest.mark.parametrize("T,window", [(10, 0), (12, 5)])
def test_chunked_attention_matches_jax(T, window):
    """The online-softmax attention over key blocks of attention_block=4
    (shrunk to 2 where 4 does not divide T=10) against the reference's
    chunked_attention."""
    cfg = get_smoke_config("qwen3_0_6b").replace(
        attention_impl="chunked", attention_block=4, sliding_window=window)
    jcfg = jax_smoke("qwen3_0_6b").replace(
        attention_impl="chunked", attention_block=4, sliding_window=window)
    q, k, v = _qkv(T, 2, T, 4, 2, 64)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    want = JL.chunked_attention(q, k, v, pos, pos, jcfg)
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(pos.copy()),
                               torch.from_numpy(pos.copy()), cfg)
    _close(got, want, LAYER_TOL, LAYER_TOL)


def test_attention_impl_chunked_is_honoured(smoke):
    """attention_impl="chunked" routes the no-cache branch to the chunked
    attention, as the reference does (it was silently ignored before), and
    agrees with JAX's chunked route."""
    jcfg, jattn, tattn = smoke
    cfg = get_smoke_config("qwen3_0_6b").replace(attention_impl="chunked",
                                                 attention_block=4)
    jcfg = jcfg.replace(attention_impl="chunked", attention_block=4)
    x = np.random.default_rng(4).normal(size=(2, 10, cfg.d_model)) \
        .astype(np.float32)
    want, _ = j_attention(jattn, x, jcfg)
    calls = []
    real = TL.chunked_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    TL.chunked_attention = spy
    try:
        got, _ = TL.attention_block(tattn, torch.from_numpy(x), cfg)
    finally:
        TL.chunked_attention = real
    assert calls == [1]
    _close(got, want, LAYER_TOL, LAYER_TOL)
    with pytest.raises(ValueError):
        TL.attention_block(tattn, torch.from_numpy(x), cfg, kernel="pallas")
