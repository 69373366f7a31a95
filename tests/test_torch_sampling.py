"""The port's sampling vs the JAX reference's: PRNG keys, the threefry
Gumbel noise (bit-exact), and the per-slot scores, argmax margins and
logprobs the serving steps emit (CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as JS  # noqa: E402
from repro_torch.serving import sampling as TS  # noqa: E402

SEEDS = [0, 1, 3, 123456789, 2**31 - 1, -1, -7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while these tests run; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_keys_match_reference():
    """PRNGKey, fold_in and the best-of branch keys, bit for bit."""
    for seed in SEEDS:
        assert TS.request_key(seed).tolist() == \
            JS.request_key(seed).tolist(), seed
        for branch in (0, 1, 2, 7):
            assert TS.branch_key(seed, branch).tolist() == \
                JS.branch_key(seed, branch).tolist(), (seed, branch)
        for step in (0, 1, 23, 2**31 - 1):
            want = jax.random.fold_in(jax.random.PRNGKey(seed), step)
            assert TS.fold_in(TS.request_key(seed), step).tolist() == \
                np.asarray(want, np.uint32).tolist(), (seed, step)


@pytest.mark.parametrize("V", [1, 7, 512, 151936])
def test_gumbel_noise_bit_exact(V):
    """jax.random.gumbel(fold_in(key, step), (V,)) reproduced bit for bit
    over a grid of seeds and steps (V=151936 is qwen3_0_6b's vocab)."""
    keys, want = [], []
    grid = (SEEDS[:5], (0, 1, 23, 1000)) if V < 1000 else (SEEDS[:2], (0, 23))
    for seed in grid[0]:
        for step in grid[1]:
            k = TS.fold_in(TS.request_key(seed), step)
            keys.append(k)
            want.append(np.asarray(JS._gumbel(
                jnp.asarray(JS.request_key(seed)), step, V)))
    got = TS.gumbel_noise(np.stack(keys), V, "cpu").numpy()
    want = np.stack(want)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _slot_sampling(rows):
    """rows: (temperature, top_k, top_p, seed, step) per slot."""
    key = np.stack([JS.request_key(r[3]) if r[0] > 0 else JS.key_zeros()
                    for r in rows])
    leaves = (key, np.array([r[4] for r in rows], np.int32),
              np.array([r[0] for r in rows], np.float32),
              np.array([r[1] for r in rows], np.int32),
              np.array([r[2] for r in rows], np.float32))
    return JS.SlotSampling(*leaves), TS.SlotSampling(*leaves)


MIXED = [(0.0, 0, 1.0, 0, 0),        # greedy
         (0.8, 0, 1.0, 11, 3),       # temperature only
         (1.1, 40, 1.0, 12, 0),      # top-k
         (0.7, 0, 0.9, 13, 9),       # nucleus
         (0.9, 20, 0.95, 14, 5)]     # top-k then nucleus


@pytest.mark.parametrize("rows", [
    MIXED, [MIXED[0], MIXED[1], MIXED[1], MIXED[0], MIXED[1]], [MIXED[0]] * 5],
    ids=["filtered", "temperature", "greedy"])
def test_batched_scores_match_reference(rows):
    """Scores are bit-equal: the same fp32 division, the same noise bits,
    the same rank-based keep mask (-inf outside it)."""
    logits = np.random.default_rng(0).normal(
        size=(len(rows), 512)).astype(np.float32) * 3
    js, ts = _slot_sampling(rows)
    want = np.asarray(jax.jit(JS.batched_scores)(logits, js))
    got = TS.batched_scores(torch.from_numpy(logits), ts).numpy()
    assert np.array_equal(got, want)
    tok, margin = TS.argmax_with_margin(torch.from_numpy(got))
    jtok, jmargin = JS.argmax_with_margin(jnp.asarray(want))
    assert tok.tolist() == np.asarray(jtok).tolist()
    np.testing.assert_allclose(margin.numpy(), np.asarray(jmargin),
                               rtol=0, atol=0)
    lp = TS.token_logprob(torch.from_numpy(logits), tok)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(JS.token_logprob(logits, jtok)),
        rtol=1e-6, atol=1e-6)  # log-softmax: fp32, reduction order


def test_row_scores_match_reference():
    """The prefill step's single-row form (scalar leaves)."""
    logits = np.random.default_rng(1).normal(size=(512,)).astype(np.float32)
    js, ts = _slot_sampling([MIXED[4]])
    jrow = JS.SlotSampling(*(np.asarray(l)[0] for l in js))
    trow = TS.SlotSampling(*(np.asarray(l)[0] for l in ts))
    want = np.asarray(jax.jit(JS.row_scores)(logits, jrow))
    got = TS.row_scores(torch.from_numpy(logits), trow).numpy()
    assert np.array_equal(got, want)


def test_sampling_params_validation():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(branch=-1)):
        with pytest.raises(ValueError):
            JS.SamplingParams(**bad)
        with pytest.raises(ValueError):
            TS.SamplingParams(**bad)
