"""PyTorch port vs the JAX reference: the no-cache prefill of the dense,
hybrid and RWKV6 families (smoke widths, CPU).

Weights are made once per architecture by the reference's
``init_params`` and carried over with ``params_from_jax``.
``make_prefill_step(kernel="cuda")`` on CPU tensors (the kernels' plain
versions) is held against JAX's ``use_pallas=True`` (Pallas in interpret
mode), and ``kernel="torch"`` against ``use_pallas=False``: fp32 with a
different reduction order, so logits within 1e-4 and single mixers within
1e-5, as the dense forward's tests hold them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import serve_step as JSS  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       params_from_jax)
from repro_torch.serving.serve_step import make_prefill_step  # noqa: E402

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ("qwen3_0_6b", "zamba2_2_7b", "rwkv6_7b")
j_mamba2 = jax.jit(JS.mamba2_block, static_argnums=(2,))
j_timemix = jax.jit(JS.rwkv6_timemix, static_argnums=(2,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """{arch: (JAX params, the port's params)} at smoke widths, made once."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_smoke(arch)
        jp = jax.jit(lambda k, c=jcfg: JP.init_params(k, c)[0])(
            jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         "cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel,use_pallas", [("cuda", True),
                                               ("torch", False)])
def test_make_prefill_step_matches_jax(weights, arch, kernel, use_pallas):
    jp, tp = weights[arch]
    toks = np.random.default_rng(0).integers(
        0, jax_smoke(arch).vocab_size, (2, 128)).astype(np.int32)
    want = jax.jit(JSS.make_prefill_step(jax_smoke(arch),
                                         use_pallas=use_pallas))(
        jp, jnp.asarray(toks))
    got = make_prefill_step(get_smoke_config(arch), kernel=kernel)(
        tp, torch.from_numpy(toks.astype(np.int64)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _x(seed, D, S=40):
    return np.random.default_rng(seed).normal(size=(2, S, D)) \
        .astype(np.float32)


def _layer(tree, idx):
    return jax.tree.map(lambda a: np.asarray(a[idx]), tree)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_mamba2_block_matches_jax(weights):
    """zamba2's first Mamba2 layer (leaves stacked (groups, per group)) on
    the plain route; the kernel route is held through make_prefill_step."""
    jp, _ = weights["zamba2_2_7b"]
    p = _layer(jp["layers"]["mamba"], (0, 0))
    jcfg, cfg = jax_smoke("zamba2_2_7b"), get_smoke_config("zamba2_2_7b")
    x = _x(1, cfg.d_model)
    want, _ = j_mamba2(p, x, jcfg)
    got, state = TS.mamba2_block(params_from_jax(p, "cpu"),
                                 torch.from_numpy(x), cfg)
    assert state is None
    _close(got, want)


def test_rwkv6_timemix_matches_jax(weights):
    jp, _ = weights["rwkv6_7b"]
    p = _layer(jp["layers"]["rwkv"], 0)
    jcfg, cfg = jax_smoke("rwkv6_7b"), get_smoke_config("rwkv6_7b")
    x = _x(2, cfg.d_model)
    want, _ = j_timemix(p, x, jcfg)
    got, _ = TS.rwkv6_timemix(params_from_jax(p, "cpu"), torch.from_numpy(x),
                              cfg)
    _close(got, want)


def test_rwkv6_channelmix_and_conv_match_jax(weights):
    jp, _ = weights["rwkv6_7b"]
    p = _layer(jp["layers"]["rwkv"]["cm"], 1)
    jcfg, cfg = jax_smoke("rwkv6_7b"), get_smoke_config("rwkv6_7b")
    x = _x(3, cfg.d_model)
    want, _ = JS.rwkv6_channelmix(p, x, jcfg)
    got, _ = TS.rwkv6_channelmix(params_from_jax(p, "cpu"),
                                 torch.from_numpy(x), cfg)
    _close(got, want)
    w = np.random.default_rng(4).normal(size=(4, cfg.d_model)) \
        .astype(np.float32)
    want_y, want_tail = JS.causal_conv1d(x, w)
    got_y, got_tail = TS.causal_conv1d(torch.from_numpy(x),
                                       torch.from_numpy(w))
    _close(got_y, want_y)
    _close(got_tail, want_tail)


def test_rms_norm_gated_and_token_shift_match_jax():
    rng = np.random.default_rng(5)
    y, z = (rng.normal(size=(2, 6, 32)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(32,)).astype(np.float32)
    _close(TS.rms_norm_gated(*map(torch.from_numpy, (y, z, g)), 1e-6),
           JS.rms_norm_gated(y, z, g, 1e-6))
    xx, last = TS.token_shift(torch.from_numpy(y))
    jxx, jlast = JS.token_shift(y)
    _close(xx, jxx, 0)
    _close(last, jlast, 0)


def _tree(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
def test_init_params_tree_matches_reference_smoke(weights, arch):
    """Paths, shapes and dtypes of init_params against the reference's at
    smoke width; and params_from_jax carries the reference's tree with the
    same paths, shapes and dtypes."""
    jp, tp = weights[arch]
    want = _tree(jax.tree.map(np.asarray, jp))
    mine = init_params(get_smoke_config(arch),
                       torch.Generator().manual_seed(0), "cpu")
    assert _tree(mine) == want
    assert _tree(tp) == want


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
def test_init_params_tree_matches_reference_full(arch):
    """The same at full width, without drawing: the reference's tree from
    jax.eval_shape, the port's on the meta device.  The reference casts
    its fp32 ``init=`` leaves (A_log, dt_bias, D_skip, w0, u) to the
    config's bf16, and so does the port."""
    want = _tree(jax.eval_shape(lambda k: JP.init_params(k, jax_full(arch))[0],
                                jax.random.PRNGKey(0)))
    mine = _tree(init_params(get_config(arch), torch.Generator(), "meta"))
    assert mine == want
    assert {d for _, d in mine.values()} == {"bfloat16"}


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_match_reference(arch, which):
    mine, ref = ((get_config, jax_full) if which == "full"
                 else (get_smoke_config, jax_smoke))
    assert dataclasses.asdict(mine(arch)) == dataclasses.asdict(ref(arch))


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "rwkv6_7b"])
def test_recurrent_decode_is_not_ported(weights, arch):
    """The recurrent families' decode (a cache) and the mixers' carried
    state raise NotImplementedError; the dense paged cache is not taken."""
    _, tp = weights[arch]
    cfg = get_smoke_config(arch)
    toks = torch.zeros(2, 1, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        TT.forward(tp, cfg, toks,
                   cache={"pos": torch.zeros(2, dtype=torch.int32)})
    x = torch.zeros(2, 1, cfg.d_model)
    p = TT.layer_params(tp["layers"], (0, 0) if arch == "zamba2_2_7b" else 0)
    with pytest.raises(NotImplementedError):
        if arch == "zamba2_2_7b":
            TS.mamba2_block(p["mamba"], x, cfg, state={})
        else:
            TS.rwkv6_timemix(p["rwkv"], x, cfg, state={})
    with pytest.raises(NotImplementedError):
        TS.token_shift(x, torch.zeros(2, cfg.d_model))
