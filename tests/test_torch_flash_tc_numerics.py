"""The arithmetic of the bf16 tensor-core flash-attention kernel
(src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu), held
against the JAX package on the CPU.

The kernel cannot run here, so this file writes its order of operations
out in plain PyTorch (``emulate``): bf16-representable q, k, v; fp32
logits; 128 query rows per CTA and the online softmax over the CTA's key
blocks of 128, skipping blocks that no row of the CTA admits; -1e30 for
masked logits and p = 0 for masked keys; l summed from the unrounded fp32
p; and p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), each
multiplied with V in fp32 (the tensor cores' bf16 x bf16 products are
exact, their sums fp32).  The emulation, in fp32, is held against the
reference's Pallas kernel in interpret mode (``flash_attention_bhsd``
through ``repro.kernels.flash_attention.ops``) and against the port's
plain version (``ref.reference_attention``), which also takes a ragged S.

Tolerance ``TOL`` = 1e-4 (absolute and relative, fp32): with the split,
p is carried to about 2^-17 of itself (p_lo's own rounding), so an output
of sum(p v) / l moves by at most 2^-17 * max|v| = 3.8e-5 for |v| < 5 (the
inputs' largest), and the two sides' fp32 sums differ by about 1e-6; the
emulation lands 3e-6 to 6e-6 from the Pallas kernel.  One bf16 term (p
rounded to 8 significant bits) moves the output by up to 2^-9 * max|v|:
2e-3 to 3e-3 here, which the last test shows misses ``TOL`` — the reason
the kernel spends a second PV product on p_lo.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

TOL = 1e-4
BQ = BK = 128  # the kernel's query rows per CTA and keys per block

# (name, B, S, H, KV, hd, window, chunk); S a multiple of the reference
# kernel's 128-row blocks, and more than one key block
CASES = [
    ("hd64", 1, 256, 2, 2, 64, 0, 0),
    ("hd80-gqa2", 1, 256, 4, 2, 80, 0, 0),
    ("hd128", 1, 256, 2, 2, 128, 0, 0),
    ("hd64-gqa2-window", 1, 256, 4, 2, 64, 96, 0),
    ("hd128-gqa2-chunk", 1, 256, 4, 2, 128, 0, 64),
]
# the port's side alone: the reference kernel asserts block multiples
RAGGED = ("hd80-gqa2-ragged-window", 2, 200, 4, 2, 80, 48, 0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(case):
    """bf16-representable q, k, v as fp32 numpy arrays, from a seed."""
    name, B, S, H, KV, hd, _, _ = case
    rng = np.random.default_rng(B * S + H * hd)
    return [np.array(jnp.asarray(rng.normal(size=(B, S, n, hd)), jnp.bfloat16)
                     .astype(jnp.float32)) for n in (H, KV, KV)]


@pytest.fixture(scope="module")
def jax_out():
    """The reference's Pallas kernel (interpret mode) on every case, fp32."""
    out = {}
    for case in CASES:
        name, *_, window, chunk = case
        q, k, v = (jnp.asarray(a) for a in _inputs(case))
        out[name] = np.asarray(j_fa.flash_attention(q, k, v, window=window,
                                                    chunk=chunk))
    return out


def _admitted(qp, kp, S, window, chunk):
    ok = (kp < S) & (kp <= qp)
    if window:
        ok &= kp > qp - window
    if chunk:
        ok &= (kp // chunk) == (qp // chunk)
    return ok


def emulate(q, k, v, *, window=0, chunk=0, split=True):
    """The tensor-core kernel's order of operations (causal), in fp32.
    q: (B, S, H, hd), k/v: (B, S, KV, hd).  Returns (B, S, H, hd) fp32,
    before the kernel's one rounding to bf16."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scale = 1.0 / hd ** 0.5
    out = torch.zeros(B, H, S, hd)
    for q0 in range(0, S, BQ):
        q_last = min(q0 + BQ, S) - 1
        lo, hi = 0, q_last  # the CTA's key range: causal, window, chunk
        if window:
            lo = max(lo, q0 - window + 1)
        if chunk:
            lo = max(lo, q0 // chunk * chunk)
            hi = min(hi, q_last // chunk * chunk + chunk - 1)
        qp = torch.arange(q0, q0 + BQ)[:, None]
        qt = torch.zeros(B, H, BQ, hd)  # rows past S zero-filled
        qt[:, :, :q_last + 1 - q0] = q[:, :, q0:q_last + 1]
        m = torch.full((B, H, BQ), -1e30)
        l = torch.zeros(B, H, BQ)
        acc = torch.zeros(B, H, BQ, hd)
        for k0 in range(lo // BK * BK, hi + 1, BK):
            kp = torch.arange(k0, k0 + BK)[None, :]
            kt = torch.zeros(B, H, BK, hd)  # keys past S zero-filled
            vt = torch.zeros(B, H, BK, hd)
            n = min(k0 + BK, S) - k0
            kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
            mask = _admitted(qp, kp, S, window, chunk)
            s = torch.where(mask, qt @ kt.mT * scale, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            p_hi = p.bfloat16().float()
            pv = p_hi @ vt
            if split:
                pv = pv + (p - p_hi).bfloat16().float() @ vt
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0:q_last + 1] = o[:, :, :q_last + 1 - q0]
    return out.permute(0, 2, 1, 3)


def _emulated(case, split=True):
    *_, window, chunk = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    return emulate(q, k, v, window=window, chunk=chunk, split=split)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_p_matches_jax_kernel(case, jax_out):
    """The emulated kernel against the reference's Pallas kernel."""
    got = _emulated(case)
    np.testing.assert_allclose(got.numpy(), jax_out[case[0]], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES + [RAGGED],
                         ids=[c[0] for c in CASES + [RAGGED]])
def test_split_p_matches_port_reference(case):
    """The emulated kernel against the port's plain version (the full
    masked fp32 softmax), a ragged S included."""
    *_, window, chunk = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    want = ref.reference_attention(q, k, v, window=window, chunk=chunk)
    got = emulate(q, k, v, window=window, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_one_bf16_p_term_misses_the_tolerance(jax_out):
    """Without p_lo (p rounded to bf16 once, as a single tensor-core term
    would take it) the same case misses TOL by an order of magnitude."""
    case = CASES[2]
    want = jax_out[case[0]]
    split = np.abs(_emulated(case).numpy() - want).max()
    single = np.abs(_emulated(case, split=False).numpy() - want).max()
    assert split <= TOL < single / 10, (split, single)
