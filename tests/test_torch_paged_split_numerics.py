"""The arithmetic of the split paged-attention kernel
(src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu), held
against the JAX package on the CPU.

The kernel cannot run here, so this file writes its order of operations
out in numpy fp32 (``emulate``): the S new rows scattered into the pools
first; then, per (slot, KV head, query row), the ring cut into splits of
``pages_per_split`` block-table entries; inside a split, key t goes to key
group (t - split start) mod n_groups (the kernel's lane groups), and each
group keeps a partial softmax (m, l, acc) over its admitted keys; the
groups' partials merge into the split's, the splits' into the row's output
by log-sum-exp rescaling.  A partial with no admitted key is empty (m =
-1e30, l = 0) and is skipped by selection: its acc is never read, and it
adds no exp(-1e30 - (-1e30)) = 1 term.  The output is acc / max(l, 1e-30).

The emulation is held against the reference's Pallas kernel in interpret
mode (``repro.kernels.paged_attention.ops.paged_attention_update``, as
tests/test_torch_paged_attention.py runs it) on the same numpy inputs, at
the smoke shapes of that file's ``CASES`` plus a case where every split
but one is empty, at pages_per_split 1, 2 and 4.  Tolerance ``TOL`` =
1e-5 absolute and relative, fp32: the two sides add the same terms in
another order (about 1e-7 apart).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as jops  # noqa: E402

TOL = 1e-5
PSZ = 16
NEG_INF = np.float32(-1e30)
WARPS, SLICE = 4, 16  # the kernel's kWarps and kSlice

# (name, inputs, window, q_positions): tests/test_torch_paged_attention.py's
# CASES, and one where only the first page holds admitted keys
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
    ("one_split_admitted", dict(B=2, S=2, H=4, KV=2, hd=64, P=5,
                                n_pages=11, lasts=[3, 13]), 0, False),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(name, B, S, H, KV, hd, P, n_pages, lasts):
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bt = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P)
    return dict(q=f(B, S, H, hd), k_new=f(B, S, KV, hd),
                v_new=f(B, S, KV, hd), k_pool=f(n_pages, PSZ, KV, hd),
                v_pool=f(n_pages, PSZ, KV, hd),
                block_table=bt.astype(np.int32),
                last_pos=np.array(lasts, np.int32))


def _q_positions(x, S, qpos):
    if not qpos:
        return None
    return (x["last_pos"][:, None] - (S - 1)
            + np.arange(S, dtype=np.int32)[None])


@pytest.fixture(scope="module")
def jax_out():
    """The reference's Pallas kernel (interpret mode) on every case."""
    out = {}
    for name, shape, window, qpos in CASES:
        x = _inputs(name, **shape)
        qp = _q_positions(x, shape["S"], qpos)
        o, _, _ = jops.paged_attention_update(
            *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pool",
                                          "v_pool", "block_table",
                                          "last_pos")),
            window=window, q_positions=None if qp is None else jnp.asarray(qp))
        out[name] = np.asarray(o)
    return out


def partials(scores, v, masks):
    """One partial softmax per row of `masks` (n, T) over the admitted
    keys: (m, l, acc); m = -1e30 and l = 0 where none is admitted."""
    s = np.where(masks, scores[None], NEG_INF).astype(np.float32)
    m = s.max(axis=1)
    p = np.where(masks, np.exp(s - m[:, None]), np.float32(0))
    return m, p.sum(axis=1, dtype=np.float32), (p @ v).astype(np.float32)


def merge(m, l, acc):
    """Log-sum-exp merge of partials (n,), (n,), (n, hd); empty ones (l = 0)
    are skipped by selection, their acc never read."""
    live = l > 0
    mx = np.max(np.where(live, m, NEG_INF))
    w = np.where(live, np.exp(np.where(live, m - mx, 0)), np.float32(0))
    tot = np.where(live[:, None], acc * w[:, None], np.float32(0))
    return mx, np.float32((l * w).sum()), tot.sum(axis=0, dtype=np.float32)


def emulate(x, window, q_positions, pages_per_split, *, poison=False):
    """The kernel's arithmetic in numpy fp32.  With `poison`, every empty
    partial's acc is NaN (the kernel leaves it unwritten)."""
    q = x["q"]
    kp, vp = x["k_pool"].copy(), x["v_pool"].copy()
    bt, last = x["block_table"], x["last_pos"]
    B, S, H, hd = q.shape
    KV = kp.shape[2]
    g, P = H // KV, bt.shape[1]
    T = P * PSZ
    for b in range(B):  # the scatter
        for s in range(S):
            slot = (last[b] - (S - 1) + s) % T
            kp[bt[b, slot // PSZ], slot % PSZ] = x["k_new"][b, s]
            vp[bt[b, slot // PSZ], slot % PSZ] = x["v_new"][b, s]
    qpos = q_positions if q_positions is not None else (
        last[:, None] - (S - 1) + np.arange(S)[None])
    n_groups = WARPS * 32 // (hd // SLICE)
    keys = pages_per_split * PSZ
    ring = np.arange(T)
    split, group = ring // keys, (ring % keys) % n_groups
    n_split = split.max() + 1
    scale = np.float32(1 / np.sqrt(hd))
    out = np.zeros_like(q)
    for b in range(B):
        k_pos = last[b] - (last[b] - ring) % T
        page = bt[b, ring // PSZ]
        for kv in range(KV):
            K, V = kp[page, ring % PSZ, kv], vp[page, ring % PSZ, kv]
            for r in range(S * g):
                s, h = r // g, kv * g + r % g
                qp = qpos[b, s]
                ok = (k_pos >= 0) & (k_pos <= qp)
                if window > 0:
                    ok &= k_pos > qp - window
                scores = (K @ q[b, s, h]).astype(np.float32) * scale
                parts = []
                for sp in range(n_split):
                    masks = np.stack([ok & (split == sp) & (group == gi)
                                      for gi in range(n_groups)])
                    m, l, acc = merge(*partials(scores, V, masks))
                    if poison and l == 0:
                        acc = np.full(hd, np.nan, np.float32)
                    parts.append((m, l, acc))
                m, l, acc = merge(*(np.array(z) for z in zip(*parts)))
                out[b, s, h] = acc / max(l, np.float32(1e-30))
    return out


@pytest.mark.parametrize("pages_per_split", [1, 2, 4])
@pytest.mark.parametrize("name,shape,window,qpos", CASES,
                         ids=[c[0] for c in CASES])
def test_split_arithmetic_matches_reference_kernel(jax_out, name, shape,
                                                   window, qpos,
                                                   pages_per_split):
    x = _inputs(name, **shape)
    got = emulate(x, window, _q_positions(x, shape["S"], qpos),
                  pages_per_split)
    np.testing.assert_allclose(got, jax_out[name], rtol=TOL, atol=TOL)


def test_empty_splits_add_nothing():
    """Every split but the first is empty here; their partials' acc is
    never read (NaN there leaves the output finite and equal), and the
    result equals the unsplit one (one split holding the whole ring)."""
    name, shape, window, qpos = CASES[-1]
    x = _inputs(name, **shape)
    one = emulate(x, window, None, shape["P"])
    split = emulate(x, window, None, 1, poison=True)
    assert np.isfinite(split).all()
    np.testing.assert_allclose(split, one, rtol=TOL, atol=TOL)


def test_all_empty_row_gives_zero():
    """A row no entry admits (every partial empty) comes out as 0, as the
    reference's fully masked rows do: no 1 term from exp(-1e30 + 1e30)."""
    m = np.full(4, NEG_INF, np.float32)
    mx, l, acc = merge(m, np.zeros(4, np.float32),
                       np.full((4, 8), np.nan, np.float32))
    assert l == 0 and mx == NEG_INF
    np.testing.assert_array_equal(acc / max(l, np.float32(1e-30)),
                                  np.zeros(8, np.float32))
