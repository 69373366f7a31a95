"""The port's paged-attention wrappers vs the JAX reference's.

On the CPU the port's ``ops.paged_attention_update`` / ``paged_attention``
run the kernel's plain version; the JAX side runs its Pallas kernel in
interpret mode, as tests/test_paged_attention_kernel.py does.  Same numpy
inputs, fp32: outputs within atol 1e-5 (different reduction order — an
online softmax over page tiles against one softmax over the ring), pool
rows bit-equal (both copy the same values).  The CUDA kernel itself runs
only on a card: tests/test_torch_kernels_gpu.py holds it against this
plain version there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

TOL = 1e-5
PSZ = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, B, S, H, KV, hd, P, n_pages, lasts):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bt = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    return dict(q=f(B, S, H, hd), k_new=f(B, S, KV, hd),
                v_new=f(B, S, KV, hd), k_pool=f(n_pages, PSZ, KV, hd),
                v_pool=f(n_pages, PSZ, KV, hd),
                block_table=bt.astype(np.int32),
                last_pos=np.array(lasts, np.int32))


# (name, inputs, window, q_positions); P=3 pages is padded to the JAX
# kernel's tile_k=4 with null pages, P=5 to 8
CASES = [
    ("decode", dict(B=3, S=1, H=4, KV=2, hd=64, P=3, n_pages=11,
                    lasts=[0, 17, 47]), 0, False),
    ("block_S4", dict(B=3, S=4, H=4, KV=2, hd=64, P=3, n_pages=11,
                      lasts=[3, 20, 47]), 0, False),
    ("ring_wrap", dict(B=3, S=1, H=4, KV=2, hd=64, P=3, n_pages=11,
                       lasts=[48, 3 * 48 + 7, 100]), 0, False),
    ("window", dict(B=3, S=4, H=4, KV=2, hd=64, P=3, n_pages=11,
                    lasts=[3, 30, 47]), 20, False),
    ("tile_pad_q_positions", dict(B=2, S=4, H=8, KV=2, hd=64, P=5,
                                  n_pages=11, lasts=[9, 70]), 0, True),
]


@pytest.mark.parametrize("name,shape,window,qpos", CASES,
                         ids=[c[0] for c in CASES])
def test_update_matches_reference_kernel(name, shape, window, qpos):
    x = _inputs(sum(map(ord, name)), **shape)
    S = shape["S"]
    q_positions = None
    if qpos:  # per-row positions (a resume block): the block itself
        q_positions = (x["last_pos"][:, None] - (S - 1)
                       + np.arange(S, dtype=np.int32)[None])
    want, wk, wv = jops.paged_attention_update(
        *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pool",
                                      "v_pool", "block_table", "last_pos")),
        window=window,
        q_positions=None if q_positions is None else jnp.asarray(q_positions))
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    launches = ops.paged_attention_update.launches
    out, kp, vp = ops.paged_attention_update(
        t["q"], t["k_new"], t["v_new"], t["k_pool"], t["v_pool"],
        t["block_table"], t["last_pos"], window=window,
        q_positions=None if q_positions is None
        else torch.from_numpy(q_positions))
    assert ops.paged_attention_update.launches == launches  # no kernel
    assert kp is t["k_pool"] and vp is t["v_pool"]  # in place
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(kp[1:].numpy(), np.asarray(wk)[1:])
    np.testing.assert_array_equal(vp[1:].numpy(), np.asarray(wv)[1:])


def test_attention_only_matches_reference_kernel():
    x = _inputs(5, **CASES[0][1])
    want = jops.paged_attention(
        *(jnp.asarray(x[k]) for k in ("q", "k_pool", "v_pool",
                                      "block_table", "last_pos")))
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    out = ops.paged_attention(t["q"], t["k_pool"], t["v_pool"],
                              t["block_table"], t["last_pos"])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    one = ref.reference_paged_attention(t["q"][:, 0], t["k_pool"],
                                        t["v_pool"], t["block_table"],
                                        t["last_pos"])
    np.testing.assert_allclose(one.numpy(), out[:, 0].numpy(), rtol=TOL,
                               atol=TOL)


def _bad(kind):
    x = _inputs(6, B=2, S=2, H=4, KV=2, hd=64, P=2, n_pages=6, lasts=[5, 9])
    if kind == "block_table_float":
        x["block_table"] = x["block_table"].astype(np.float32)
    elif kind == "last_pos_not_int32":
        x["last_pos"] = x["last_pos"].astype(np.float32)
    elif kind == "S_above_ring":
        x = _inputs(6, B=1, S=33, H=4, KV=2, hd=64, P=2, n_pages=6,
                    lasts=[40])
    elif kind == "heads_not_grouped":
        x["q"] = x["q"][:, :, :3]
    elif kind == "k_new_shape":
        x["k_new"] = x["k_new"][:, :1]
    return x


@pytest.mark.parametrize("kind", ["block_table_float", "last_pos_not_int32",
                                  "S_above_ring",
                                  "heads_not_grouped", "k_new_shape"])
def test_rejects_what_the_reference_rejects(kind):
    """The eligibility rules raise ValueError in both packages."""
    x = _bad(kind)
    order = ("q", "k_new", "v_new", "k_pool", "v_pool", "block_table",
             "last_pos")
    with pytest.raises(ValueError):
        jops.paged_attention_update(*(jnp.asarray(x[k]) for k in order))
    with pytest.raises(ValueError):
        ops.paged_attention_update(*(torch.from_numpy(x[k]) for k in order))
    if kind == "last_pos_not_int32":  # and torch's default int64 (JAX
        # without x64 cannot hold one)
        t = [torch.from_numpy(x[k]) for k in order]
        t[-1] = t[-1].long()
        with pytest.raises(ValueError):
            ops.paged_attention_update(*t)


def test_null_page_garbage_is_masked():
    """Unallocated entries point at the null page 0; poisoning it must not
    reach a live slot, and an idle lane wholly on page 0 stays finite."""
    x = _inputs(7, B=2, S=1, H=4, KV=2, hd=64, P=3, n_pages=8, lasts=[0, 0])
    x["block_table"][0] = [7, 0, 0]
    x["block_table"][1] = 0
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    t["k_pool"][0] = 1e4
    t["v_pool"][0] = 1e4
    out, _, _ = ops.paged_attention_update(
        t["q"], t["k_new"], t["v_new"], t["k_pool"], t["v_pool"],
        t["block_table"], t["last_pos"])
    assert torch.isfinite(out).all()
    # slot 0 attends only to its own new row: the output is its v_new row
    want = np.repeat(x["v_new"][0, 0], 2, axis=0)
    np.testing.assert_allclose(out[0, 0].numpy(), want, rtol=TOL, atol=TOL)


def test_rejects_other_devices():
    x = _inputs(8, B=1, S=1, H=4, KV=2, hd=64, P=2, n_pages=4, lasts=[3])
    t = {k: torch.from_numpy(v).to("meta") for k, v in x.items()}
    with pytest.raises(ValueError):
        ops.paged_attention(t["q"], t["k_pool"], t["v_pool"],
                            t["block_table"], t["last_pos"])
