"""The port's serving policy layer against the JAX reference's rules:
ServingConfig and submit-time validation raise where the reference
raises, and the lifecycle controls keep the reference's contracts —
cancel / deadline expiry reclaim every page, and a RecomputeRecipe moved
to another batcher continues the request token for token (CPU, smoke
widths)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving import ServingConfig as JConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SamplingParams as JSP  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, Request,  # noqa: E402
                                 SamplingParams, ServingConfig)

PAGED = dict(n_slots=3, capacity=48, cache_layout="paged", n_pages=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke("qwen3_0_6b")
    jparams = jax.jit(lambda k: JP.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_smoke_config("qwen3_0_6b"), tparams


BAD_CONFIGS = [dict(prefill_mode="eager"), dict(cache_layout="ring"),
               dict(allocation="greedy"), dict(n_slots=0), dict(capacity=1),
               dict(page_size=0), dict(n_pages=1),
               dict(kernel="KERNEL", cache_layout="dense")]


@pytest.mark.parametrize("bad", BAD_CONFIGS,
                         ids=[next(iter(b)) for b in BAD_CONFIGS[:-1]]
                         + ["kernel_needs_paged"])
def test_serving_config_rejects_like_reference(bad):
    """"KERNEL" stands for the kernel path: "pallas" in the reference,
    "cuda" in the port."""
    with pytest.raises(ValueError):
        JConfig(**{k: ("pallas" if v == "KERNEL" else v)
                   for k, v in bad.items()})
    with pytest.raises(ValueError):
        ServingConfig(**{k: ("cuda" if v == "KERNEL" else v)
                         for k, v in bad.items()})


def test_serving_config_coercions_match_reference():
    kw = dict(cache_layout="dense", allocation="lazy", prefill_chunk=0,
              min_quantum=-3)
    j, t = JConfig(**kw), ServingConfig(**kw)
    assert (j.allocation, j.prefill_chunk, j.min_quantum) == \
        (t.allocation, t.prefill_chunk, t.min_quantum) == ("worst_case", 1, 0)


BAD_REQUESTS = {
    "empty_prompt": dict(prompt=[], max_new=4),
    "prompt_fills_capacity": dict(prompt=list(range(1, 49)), max_new=4),
    "max_new_zero": dict(prompt=[1, 2], max_new=0),
    "best_of_zero": dict(prompt=[1, 2], max_new=4, best_of=0),
    "best_of_above_slots": dict(prompt=[1, 2], max_new=4, best_of=4),
    "best_of_with_branch": dict(prompt=[1, 2], max_new=4, best_of=2,
                                sampling="branch"),
}


@pytest.mark.parametrize("kind", list(BAD_REQUESTS))
def test_submit_rejects_like_reference(models, kind):
    jcfg, jparams, cfg, tparams = models
    spec = dict(BAD_REQUESTS[kind])
    branch = spec.pop("sampling", None) == "branch"
    jb = JBatcher(jcfg, jparams, JConfig(**PAGED))
    tb = ContinuousBatcher(cfg, tparams, ServingConfig(**PAGED),
                           device="cpu")
    with pytest.raises(ValueError):
        jb.submit([JRequest(rid=0, sampling=JSP(temperature=0.5, branch=1)
                            if branch else None, **spec)])
    with pytest.raises(ValueError):
        tb.submit([Request(rid=0, sampling=SamplingParams(
            temperature=0.5, branch=1) if branch else None, **spec)])
    assert not tb.queue  # nothing enqueued


def _mix(cfg):
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               5 + 4 * i).tolist(),
                    max_new=8, sampling=SamplingParams(
                        temperature=0.9, top_k=30, seed=i) if i % 2 else None)
            for i in range(4)]


def test_cancel_and_deadlines_reclaim_pages(models):
    _, _, cfg, tparams = models
    b = ContinuousBatcher(cfg, tparams, ServingConfig(
        **PAGED, allocation="lazy"), device="cpu")
    reqs = _mix(cfg)
    reqs[3].deadline = 5.0
    b.submit(reqs)
    b.step()
    b.step()
    running = [r.rid for r in b.slot_req if r is not None]
    queued = [r.rid for r in b.queue]
    assert running and queued
    assert b.cancel(running[0]) and b.cancel(queued[0])
    assert not b.cancel(99)
    assert b.expire_deadlines(now=10.0) == ([3] if 3 not in
                                            (running[0], queued[0]) else [])
    done, _ = b.run()
    gone = {running[0], queued[0], 3}
    assert sorted(c.rid for c in b.done) == sorted(set(range(4)) - gone)
    assert b.allocator.in_use == 0
    assert (b.engine.block_table == 0).all()


def test_recipe_migration_continues_token_for_token(models):
    """export_recipe on a running request, submit_recipe on another
    batcher: the completion equals an uninterrupted run's (the router's
    migration contract: nothing is re-sampled, the emit index never
    rewinds)."""
    _, _, cfg, tparams = models
    make = lambda: ContinuousBatcher(  # noqa: E731
        cfg, tparams, ServingConfig(**PAGED, allocation="lazy"),
        device="cpu")
    base = make()
    base.submit(_mix(cfg))
    base.run()
    want = {c.rid: c for c in base.done}

    src, dst = make(), make()
    src.submit(_mix(cfg))
    for _ in range(3):
        src.step()
    recipe = src.export_recipe(1)
    assert recipe is not None and recipe.emitted
    assert src.export_recipe(1) is None  # it left this batcher
    dst.submit_recipe(recipe)
    src.run()
    dst.run()
    got = {c.rid: c for c in src.done + dst.done}
    assert sorted(got) == sorted(want)
    for rid, c in want.items():
        assert got[rid].tokens == c.tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, c.logprobs,
                                   rtol=1e-5, atol=1e-5)
    assert recipe.nbytes() == 4 * (len(recipe.prompt) + len(recipe.emitted)) \
        + 8 * len(recipe.emitted) + 72
