"""The port's paged serving slice end to end against the JAX reference
(smoke widths, CPU).

(a) Engine level, teacher-forced: JAX's PagedEngine (kernel="xla") and the
    port's (kernel="torch", and kernel="cuda", whose CPU tensors take the
    kernel's plain version) are driven tick by tick with identical host
    inputs — tokens, positions, block tables, a fork with its
    copy-on-write page copy, sampling rows — and both take JAX's emitted
    tokens as the next input.  Each tick compares the logits and scores
    (atol 1e-4: fp32, different reduction order), the margins and
    logprobs, the argmax wherever JAX's margin exceeds the 1e-3 tie
    tolerance, and the pools' live pages (atol 1e-5).
(b) Batcher level: the reference runs in a FRESH subprocess (the
    tests/test_sharded_serving.py pattern), so nothing that ran earlier in
    this worker can move its tokens; it writes its parameters and its
    completions out, and the port serves the same mix through
    ContinuousBatcher with the same ServingConfig — greedy and sampled
    requests, a best_of=2 request, a forced preemption and lazy-pool
    growth — and must be completions_equivalent at the repo's tie
    tolerance of 1e-3.

Both hand the reference engine private copies of its host arrays
(`_CopyingJnp`): without them its own tokens vary from run to run in a
fresh process (1 run in 4 for this mix's best_of request), a fault of the
reference recorded in ROADMAP.md.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import kvcache as JK  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro.serving.engine import PagedEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, Request,  # noqa: E402
                                 SamplingParams, ServingConfig,
                                 completions_equivalent)
from repro_torch.serving import kvcache as TK  # noqa: E402
from repro_torch.serving import sampling as TS  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402
from repro_torch.serving.scheduler import Completion  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
TIE = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------ (a) teacher-forced engine


def _rows(spec):
    """spec: per slot (temperature, top_k, top_p, key, step) -> the JAX
    and the port SlotSampling batches (same numpy leaves)."""
    leaves = (np.stack([s[3] for s in spec]).astype(np.uint32),
              np.array([s[4] for s in spec], np.int32),
              np.array([s[0] for s in spec], np.float32),
              np.array([s[1] for s in spec], np.int32),
              np.array([s[2] for s in spec], np.float32))
    return JS.SlotSampling(*leaves), TS.SlotSampling(*leaves)


def _row(batch, s):
    return type(batch)(*(np.asarray(leaf)[s] for leaf in batch))


class _CopyingJnp:
    """jax.numpy, except that asarray copies a numpy array first.  The
    reference's PagedEngine.decode hands jnp.asarray(slot_pos, ...) to an
    asynchronous dispatch and mutates those arrays before it waits; on
    the CPU backend jnp.asarray may alias them zero-copy (ROADMAP.md,
    faults of the reference).  With copies the arithmetic is unchanged."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kw)


def test_engine_teacher_forced(monkeypatch):
    from repro.serving import engine as jax_engine

    monkeypatch.setattr(jax_engine, "jnp", _CopyingJnp())
    jcfg = jax_smoke("qwen3_0_6b")
    cfg = get_smoke_config("qwen3_0_6b")
    jparams = jax.jit(lambda k: JP.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    V = cfg.vocab_size
    # page_size 8: the prompt fills slot 0's first page and decode crosses
    # into the next; one prefill block size (4) keeps the compiles few
    kw = dict(n_slots=3, capacity=48, page_size=8)
    je = JEngine(jcfg, jparams, kernel="xla", **kw)
    ports = [PagedEngine(cfg, tparams, kernel=k, device="cpu", **kw)
             for k in ("torch", "cuda")]
    engines = [je] + ports
    rng = np.random.default_rng(0)
    p0 = rng.integers(1, V, 8).astype(np.int32)
    p1 = rng.integers(1, V, 4).astype(np.int32)
    # slot 0 greedy; slot 1 top-k sampled; slot 2 = best-of branch 1 of a
    # temperature-0.9 request forked off slot 0's prompt
    spec = [[0.0, 0, 1.0, JS.key_zeros(), 0],
            [0.8, 20, 1.0, JS.request_key(5), 0],
            [0.9, 0, 1.0, JS.branch_key(3, 1), 0]]
    j_fwd = jax.jit(lambda p, c, t: JT.forward(
        p, jcfg, t, cache=c, paged_kernel="xla").logits[:, -1])
    j_scores = jax.jit(JS.batched_scores)

    def check_pools():
        for name in ("k", "v"):
            want = np.asarray(je.cache["layers"][name])[:, 1:]
            for e in ports:
                np.testing.assert_allclose(
                    e.cache["layers"][name][:, 1:].numpy(), want,
                    rtol=POOL_TOL, atol=POOL_TOL)

    def check(outs):
        """outs: (tok, margin, logprob) per engine, JAX first; returns
        JAX's tokens (the teacher)."""
        jt, jm, jl = (np.atleast_1d(np.asarray(x)) for x in outs[0])
        for t, m, lp in outs[1:]:
            t, m, lp = (np.atleast_1d(np.asarray(x)) for x in (t, m, lp))
            np.testing.assert_allclose(m, jm, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            np.testing.assert_allclose(lp, jl, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
            sure = jm > TIE
            assert np.array_equal(t[sure], jt[sure])
        check_pools()
        return jt

    for e in engines:
        e.admit(0, [1, 2, 3, 4, 5, 6], 0)
        e.admit(1, [7, 8, 9, 10, 11, 12], 0)
    emitted = [[], [], []]
    # chunked prefill: slot 0 in two blocks of 4, slot 1 in one
    for s, prompt, blocks in ((0, p0, ((0, 4), (4, 4))),
                              (1, p1, ((0, 4),))):
        for off, size in blocks:
            jrow, trow = (_row(b, s) for b in _rows(spec))
            block = prompt[None, off:off + size]
            outs = [je.prefill_block(s, block, off, off == 0, jrow)] + \
                [e.prefill_block(s, block, off, off == 0, trow)
                 for e in ports]
            tok = check(outs)
        emitted[s].append(int(tok[0]))
        spec[s][4] = 1
        for e in engines:
            e.set_pos(s, len(prompt))
    # fork slot 0 into slot 2: the branch re-feeds the last prompt token
    # at position 7, into page 1, which it shares with slot 0 — it gets
    # page 13 (a copy of page 1, queued) and private tail pages 14..18
    for e in engines:
        e.fork_slot(0, 2)
        e.set_pos(2, 7)
        for idx, pid in enumerate(range(13, 19)):
            e.set_page(2, idx, pid)
        e.queue_copy(2, 1, 13)
    active = np.ones((3,), bool)
    for tick in range(4):
        toks = np.array([[emitted[0][-1]], [emitted[1][-1]],
                         [emitted[2][-1] if emitted[2] else p0[7]]],
                        np.int32)
        jsb, tsb = _rows(spec)
        # logits and scores of this tick, from the same pre-tick pools
        # (with the tick's copy-on-write copy applied first, as the step
        # does), on both sides
        pools = {n: np.asarray(je.cache["layers"][n]) for n in ("k", "v")}
        src, dst = je._copy_src.copy(), je._copy_dst.copy()
        jc = JK.cow_copy_pages(jcfg, {"layers": {
            n: jnp.asarray(a) for n, a in pools.items()}},
            jnp.asarray(src), jnp.asarray(dst))
        jlog = j_fwd(jparams, dict(jc, pos=jnp.array(je.slot_pos),
                                   block_table=jnp.array(je.block_table)),
                     jnp.asarray(toks))
        tc = TK.cow_copy_pages(cfg, {"layers": {
            n: torch.from_numpy(a.copy()) for n, a in pools.items()}},
            src, dst)
        tlog = TT.forward(tparams, cfg, torch.from_numpy(toks), cache=dict(
            tc, pos=torch.from_numpy(je.slot_pos.copy()),
            block_table=torch.from_numpy(je.block_table.copy()))
        ).logits[:, -1]
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jsc = np.asarray(j_scores(jlog, jsb))
        tsc = TS.batched_scores(tlog, tsb).numpy()
        assert np.array_equal(np.isfinite(tsc), np.isfinite(jsc))
        fin = np.isfinite(jsc)
        np.testing.assert_allclose(tsc[fin], jsc[fin], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        outs = [je.decode(toks, active, jsb)] + \
            [e.decode(toks, active, tsb) for e in ports]
        tok = check(outs)
        for s in range(3):
            emitted[s].append(int(tok[s]))
            spec[s][4] += 1
    assert je.decode_dispatches == 4 and je.prefill_dispatches == 3
    for e in ports:
        assert (e.decode_dispatches, e.prefill_dispatches) == (4, 3)
        assert np.array_equal(e.slot_pos, je.slot_pos)


# ------------------------------------------- (b) batcher, fresh reference

MIX = {
    # prefill_chunk 4: blocks of 1, 2 and 4 tokens (few reference compiles)
    "config": dict(n_slots=3, capacity=48, cache_layout="paged",
                   allocation="lazy", n_pages=6, prefill_chunk=4),
    "requests": [
        dict(rid=0, plen=21, max_new=10),
        dict(rid=1, plen=7, max_new=10,
             sampling=dict(temperature=0.8, seed=11)),
        dict(rid=2, plen=12, max_new=8,
             sampling=dict(temperature=1.1, top_k=12, top_p=0.95, seed=14)),
        dict(rid=3, plen=9, max_new=6, best_of=2,
             sampling=dict(temperature=0.9, seed=3)),
        dict(rid=4, plen=5, max_new=8,
             sampling=dict(temperature=0.7, top_p=0.9, seed=13)),
    ],
    "preempt": dict(tick=3, rid=1),
    "seed": 7,
}

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.models import params as Pm
    from repro.serving import (ContinuousBatcher, Request, SamplingParams,
                               ServingConfig)

    # the reference's host arrays cross as private copies (see
    # _CopyingJnp in the test module); the arithmetic is its own
    from repro.serving import engine as _engine

    class _CopyingJnp:
        def __getattr__(self, name):
            return getattr(jax.numpy, name)

        @staticmethod
        def asarray(a, *args, **kw):
            if isinstance(a, np.ndarray):
                a = a.copy()
            return jax.numpy.asarray(a, *args, **kw)

    _engine.jnp = _CopyingJnp()

    out, mix = sys.argv[1], json.loads(sys.argv[2])
    cfg = get_smoke_config("qwen3_0_6b")
    params = jax.jit(lambda k: Pm.init_params(k, cfg)[0])(
        jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez(out + "/params.npz", **{
        "/".join(k.key for k in path): np.asarray(leaf)
        for path, leaf in flat})
    rng = np.random.default_rng(mix["seed"])
    reqs = [Request(rid=r["rid"],
                    prompt=rng.integers(1, cfg.vocab_size,
                                        r["plen"]).tolist(),
                    max_new=r["max_new"], best_of=r.get("best_of", 1),
                    sampling=SamplingParams(**r["sampling"])
                    if "sampling" in r else None)
            for r in mix["requests"]]
    b = ContinuousBatcher(cfg, params, ServingConfig(**mix["config"]))
    b.submit(reqs)
    tick = 0
    while b.step():
        tick += 1
        if tick == mix["preempt"]["tick"]:
            assert b.preempt(mix["preempt"]["rid"])
    with open(out + "/completions.json", "w") as f:
        json.dump({"done": [c.__dict__ for c in b.done],
                   "counters": [b.preemptions, b.cow_copies,
                                b.page_growths, b.decode_dispatches,
                                b.prefill_dispatches]}, f)
""")


def _serve_port(cfg, params, kernel):
    rng = np.random.default_rng(MIX["seed"])
    reqs = [Request(rid=r["rid"],
                    prompt=rng.integers(1, cfg.vocab_size,
                                        r["plen"]).tolist(),
                    max_new=r["max_new"], best_of=r.get("best_of", 1),
                    sampling=SamplingParams(**r["sampling"])
                    if "sampling" in r else None)
            for r in MIX["requests"]]
    b = ContinuousBatcher(cfg, params, ServingConfig(**MIX["config"],
                                                     kernel=kernel),
                          device="cpu")
    b.submit(reqs)
    tick = 0
    while b.step():
        tick += 1
        if tick == MIX["preempt"]["tick"]:
            assert b.preempt(MIX["preempt"]["rid"])
    return b


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX reference in a fresh process: its parameters and its
    completions for MIX."""
    out = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          json.dumps(MIX)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for path, leaf in flat.items():
        d = tree
        *parents, last = path.split("/")
        for p in parents:
            d = d.setdefault(p, {})
        d[last] = leaf
    with open(out / "completions.json") as f:
        ref = json.load(f)
    return params_from_jax(tree, "cpu"), ref


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_batcher_matches_fresh_reference(reference_run, kernel):
    params, ref = reference_run
    cfg = get_smoke_config("qwen3_0_6b")
    b = _serve_port(cfg, params, kernel)
    want = [Completion(**c) for c in ref["done"]]
    assert sorted(c.rid for c in b.done) == [0, 1, 2, 3, 4]
    assert completions_equivalent(want, b.done, tie_tol=TIE)
    # host policy depends only on lengths: the same preemptions (forced
    # and lazy-pool), CoW copies, page growths and dispatches
    assert [b.preemptions, b.cow_copies, b.page_growths,
            b.decode_dispatches, b.prefill_dispatches] == ref["counters"]
    assert b.preemptions >= 2 and b.cow_copies >= 1
