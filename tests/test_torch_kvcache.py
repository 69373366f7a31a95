"""The port's paged KV cache and page allocator vs the JAX reference's:
layout, byte counts, copy-on-write page copies and the allocator's
refcount/prefix bookkeeping under the same operation sequence (CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving import kvcache as JK  # noqa: E402
from repro.serving.scheduler import PageAllocator as JAlloc  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.serving import kvcache as TK  # noqa: E402
from repro_torch.serving.scheduler import PageAllocator  # noqa: E402


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("n_slots,capacity,n_pages,page_size",
                         [(4, 256, 65, 16), (3, 48, 8, 16), (2, 100, 30, 8)])
def test_layout_and_bytes_match_reference(which, n_slots, capacity, n_pages,
                                          page_size):
    """Pages per slot, logical ring and device bytes (block table and pos
    vector included) — from shapes, nothing allocated at full width."""
    mine = (get_smoke_config if which == "smoke" else get_config)("qwen3_0_6b")
    ref = (jax_smoke if which == "smoke" else jax_full)("qwen3_0_6b")
    assert TK.paged_attn_layout(mine, capacity, page_size) == \
        JK.paged_attn_layout(ref, capacity, page_size)
    assert TK.paged_cache_bytes(mine, n_slots, capacity, n_pages,
                                page_size) == \
        JK.paged_cache_bytes(ref, n_slots, capacity, n_pages, page_size)


def test_init_paged_cache_matches_reference():
    cfg = get_smoke_config("qwen3_0_6b")
    mine = TK.init_paged_cache(cfg, 3, 48, 9, dtype=torch.float32,
                               device="cpu")
    ref = JK.init_paged_cache(jax_smoke("qwen3_0_6b"), 3, 48, 9,
                              dtype=jnp.float32)
    for name in ("k", "v"):
        assert tuple(mine["layers"][name].shape) == \
            ref["layers"][name].shape
        assert mine["layers"][name].dtype == torch.float32
        assert not mine["layers"][name].any()


def test_cow_copy_pages_matches_reference():
    """dst > 0 rows copy page src -> dst in every layer's pools; dst == 0
    rows are no-ops; the copy reads the pools as they were."""
    cfg = get_smoke_config("qwen3_0_6b")
    rng = np.random.default_rng(0)
    shape = (cfg.n_layers, 9, 16, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    src = np.array([2, 0, 5, 6], np.int32)
    dst = np.array([7, 0, 8, 5], np.int32)  # 5 is copied from AND into
    want = JK.cow_copy_pages(jax_smoke("qwen3_0_6b"),
                             {"layers": {n: jnp.asarray(a)
                                         for n, a in pools.items()}},
                             jnp.asarray(src), jnp.asarray(dst))
    cache = {"layers": {n: torch.from_numpy(a.copy())
                        for n, a in pools.items()}}
    got = TK.cow_copy_pages(cfg, cache, src, dst)
    assert got is cache
    for n in "kv":
        np.testing.assert_array_equal(got["layers"][n].numpy(),
                                      np.asarray(want["layers"][n]))


def test_page_allocator_matches_reference():
    """The same random sequence of alloc / share / fork / ensure_private /
    release / prefix registration on both allocators: identical results,
    refcounts, free lists and prefix index after every step."""
    rng = np.random.default_rng(1)
    a, b = JAlloc(12, 16, "lazy"), PageAllocator(12, 16, "lazy")
    held = []  # one entry per reference taken
    for i in range(300):
        op = rng.integers(0, 6)
        if op == 0 and a.n_free:
            pid = a.alloc()
            assert b.alloc() == pid
            held.append(pid)
        elif op == 1 and held:
            pid = held[rng.integers(len(held))]
            a.share(pid)
            b.share(pid)
            held.append(pid)
        elif op == 2 and held:
            pages = sorted(set(held))[:3]
            a.fork(pages)
            b.fork(pages)
            held.extend(pages)
        elif op == 3 and held and a.n_free:
            j = rng.integers(len(held))
            res = a.ensure_private(held[j])
            assert b.ensure_private(held[j]) == res
            held[j] = res[0]
        elif op == 4 and held:
            pid = held.pop(rng.integers(len(held)))
            a.release(pid)
            b.release(pid)
        elif op == 5 and held:
            key = (None, (int(rng.integers(3)),))
            pid = held[rng.integers(len(held))]
            a.register_prefix(key, pid)
            b.register_prefix(key, pid)
            assert a.lookup_prefix(key) == b.lookup_prefix(key)
        assert np.array_equal(a.refcount, b.refcount), i
        assert (a.n_free, a.in_use, a.peak_in_use) == \
            (b.n_free, b.in_use, b.peak_in_use)
        assert a._prefix == b._prefix


def test_page_allocator_rejects_like_reference():
    with pytest.raises(ValueError):
        PageAllocator(1, 16)
    with pytest.raises(ValueError):
        PageAllocator(8, 16, "greedy")
    b = PageAllocator(4, 16)
    with pytest.raises(ValueError):
        b.ensure_private(0)  # the null page is never written
    with pytest.raises(ValueError):
        b.share(3)  # not live
