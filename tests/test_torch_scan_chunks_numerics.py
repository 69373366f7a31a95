"""The arithmetic of the chunked GLA scan kernel
(src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu), held against the JAX
package on the CPU.

The kernel cannot run here, so this file writes its schedule out in numpy
fp32 (``emulate``), at the kernel's chunk of 256 rows and at 64 and 128
(the sizes tools/scan_chunk_tiles.py sweeps):

1. chunk states: per chunk, dS = sum_j (k_j o w_j)^T v_j with w_j =
   exp(sum of ld over the chunk's rows after j), that sum run from the
   chunk's end backwards (in 32-row tiles, each cut into segments whose
   sums come first), and g = exp(the chunk's total);
2. the pass over chunks: S_0 = 0, S_{c+1} = g_c o S_c + dS_c, the last S
   the final state;
3. outputs from S_c, in 32-row tiles of two 16-row sub-chunks, each with
   its own fp32 cumsum (cum - ld on the query side in bonus mode, as the
   plain version rounds it), the state at each sub-chunk's start made
   first and y then read from it; with one decay per row (ld broadcast
   over Dk, Mamba2's view) one exp per pair of rows.

y is held against the reference's Pallas ``ssm_scan_bhsd`` in interpret
mode (chunk 64, through the reference's wrapper), and y and the final
state against the reference's exact sequential scan (``gla_scan_exact``), in both modes, with ``TOL`` = 1e-4
absolute and relative (fp32; the sides sum the same terms in other
orders, about 1e-6 apart) — except y under extreme decay against the
exact scan (``EXACT_TOL``) and the closed-form final state of the
reference's wrapper (``FINAL_TOL``), reasons there.  A ragged S (which
the Pallas kernel does not take) is held against the exact scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssm_scan import ops as j_ss  # noqa: E402
from repro.models import ssm as JS  # noqa: E402

TOL = 1e-4
# Under -30 |N| decays a sub-chunk's fp32 cumsum reaches |cum| ~ 1000 (one
# ulp 6e-5), and the bonus mode's cum - ld (as the kernel, the reference's
# kernel and the plain version compute it) rounds at that ulp: the query
# weights of the rows just before i then sit a few 1e-5 off the exact
# scan's, which moves y by up to ~2e-4 relative.  Against the exact scan y
# is held at the reference's own 1e-3 there (as in test_torch_ssm_scan.py);
# against the Pallas kernel, which rounds alike, at TOL.
EXACT_TOL = 1e-3
# The reference wrapper's closed-form final state sums ld over the whole
# sequence in fp32 and exponentiates total - cum_t: at S = 256 and decays
# of -softplus(N(0, 1)) |cum| reaches about 200, whose fp32 ulp (1.5e-5)
# moves the exponents, and so the state relatively, by a few 1e-5 after a
# few hundred roundings; 1e-3 holds that with room (the reference's own
# kernel test allows 1e-3 against the exact scan).
FINAL_TOL = 1e-3
# the kernel's kChunk, kTile (chunk-state kernel), kChRows (output kernel)
# and kSub; CHUNK is also the reference kernel's chunk here
KERNEL_CHUNK, TILE, CH_ROWS, SUB = 256, 32, 32, 16
CHUNK = 64
B, H, DK, DV = 1, 2, 32, 32
SEGS = 256 // DK  # kernel 1's row segments: kThreads / Dk
f32 = np.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# name: (S, bonus, scalar decay, extreme decay)
CASES = {
    "mamba2-scalar": (256, False, True, False),
    "mamba2-scalar-extreme": (256, False, True, True),
    "bonus-channel": (256, True, False, False),
    "mamba2-channel": (256, False, False, False),
    "bonus-scalar": (256, True, True, False),
    "bonus-channel-extreme": (256, True, False, True),
    "bonus-channel-ragged": (200, True, False, False),
}


def _inputs(name):
    S, bonus, scalar, extreme = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.normal(size=s).astype(f32)  # noqa: E731
    q, k, v = f(B, S, H, DK), f(B, S, H, DK), f(B, S, H, DV)
    z = f(B, S, H, 1) if scalar else f(B, S, H, DK)
    ld = (-30.0 * np.abs(z) if extreme else -np.logaddexp(z, 0)).astype(f32)
    ld = np.ascontiguousarray(np.broadcast_to(ld, (B, S, H, DK)))
    u = np.abs(f(H, DK)) if bonus else None
    return q, k, v, ld, u


@pytest.fixture(scope="module")
def jax_results():
    """Per case: the Pallas kernel's y (interpret mode, chunk 64; None at
    a ragged S), the exact scan's y and state, and the wrapper's
    closed-form state."""
    out = {}
    for name, (S, _, _, _) in CASES.items():
        q, k, v, ld, u = _inputs(name)
        y_pallas = st_cf = None
        if S % CHUNK == 0:  # the wrapper runs ssm_scan_bhsd in interpret mode
            y_pallas, st_cf = map(np.asarray, j_ss.ssm_scan(
                q, k, v, ld, u=u, chunk=CHUNK))
        y_ex, st_ex = JS.gla_scan_exact(q, k, v, ld, u=u)
        out[name] = (y_pallas, np.asarray(y_ex), np.asarray(st_ex), st_cf)
    return out


# ------------------------------------------------------------ the schedule


def _chunks(a, n, C):
    """(B, S, H, X) zero-padded to n * C rows -> (B, H, n, C, X) fp32."""
    pad = n * C - a.shape[1]
    a = np.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)))
    return a.reshape(B, n, C, H, -1).transpose(0, 3, 1, 2, 4).astype(f32)


def chunk_states(k, v, ld, C):
    """Kernel 1: dS (B, H, n, Dk, Dv) and g (B, H, n, Dk).  The chunk's
    32-row tiles from its end back; in a tile, each of SEGS segments of
    rows sums its ld first, then walks its rows from the end, from the sum
    of everything after it."""
    suf = np.zeros(ld.shape[:3] + ld.shape[4:], f32)  # (B, H, n, Dk)
    kw = np.empty_like(k)
    rows = TILE // SEGS
    for t0 in range(C - TILE, -1, -TILE):
        seg = []
        for g in range(SEGS):  # each segment's sum, its rows in order
            s = np.zeros_like(suf)
            for i in range(t0 + g * rows, t0 + (g + 1) * rows):
                s = (s + ld[:, :, :, i]).astype(f32)
            seg.append(s)
        for g in range(SEGS):
            s = suf
            for later in range(SEGS - 1, g, -1):
                s = (s + seg[later]).astype(f32)
            for i in range(t0 + (g + 1) * rows - 1, t0 + g * rows - 1, -1):
                kw[:, :, :, i] = k[:, :, :, i] * np.exp(s)
                s = (s + ld[:, :, :, i]).astype(f32)
            if g == 0:
                new_suf = s
        suf = new_suf
    dS = np.einsum("bhncd,bhnce->bhnde", kw, v).astype(f32)
    return dS, np.exp(suf).astype(f32)


def pass_over_chunks(dS, g):
    """Kernel 2: the state at every chunk's start, and the final state."""
    s = np.zeros(dS.shape[:2] + dS.shape[3:], f32)
    starts = np.empty_like(dS)
    for c in range(dS.shape[2]):
        starts[:, :, c] = s
        s = (g[:, :, c, :, None] * s + dS[:, :, c]).astype(f32)
    return starts, s


def outputs(q, k, v, ld, u, S0, scalar):
    """Kernel 3: 32-row tiles of 16-row sub-chunks with fp32 cumsums; the
    states at each sub-chunk start first, then y.  scalar (one decay per
    row): A_ij = (q_i . k_j) exp(cq_i - cum_j), one exp per pair."""
    C = q.shape[3]
    y = np.zeros(v.shape, f32)
    s = S0.copy()
    i, j = np.indices((SUB, SUB))
    keep = j < i if u is not None else j <= i
    for t0 in range(0, C, CH_ROWS):
        states = []
        for s0 in range(t0, t0 + CH_ROWS, SUB):
            sl = slice(s0, s0 + SUB)
            qs, ks, vs = q[:, :, :, sl], k[:, :, :, sl], v[:, :, :, sl]
            cum = np.cumsum(ld[:, :, :, sl], axis=3, dtype=f32)
            cq = cum - ld[:, :, :, sl] if u is not None else cum
            diff = cq[:, :, :, :, None] - cum[:, :, :, None]  # (..,i,j,Dk)
            wts = np.exp(np.where(keep[..., None], diff, -np.inf)).astype(f32)
            if scalar:
                A = (np.einsum("bhnid,bhnjd->bhnij", qs, ks)
                     * wts[..., 0]).astype(f32)
            else:
                A = np.einsum("bhnid,bhnjd,bhnijd->bhnij", qs, ks, wts)
            if u is not None:
                A[..., np.arange(SUB), np.arange(SUB)] = np.einsum(
                    "bhnid,hd,bhnid->bhni", qs, u, ks)
            states.append(s)
            y[:, :, :, sl] = (np.einsum("bhnij,bhnje->bhnie", A, vs)
                              + np.einsum("bhnid,bhnde->bhnie",
                                          qs * np.exp(cq), s))
            tot = cum[:, :, :, -1]
            kw = ks * np.exp(tot[:, :, :, None] - cum)
            s = (np.exp(tot)[..., None] * s
                 + np.einsum("bhnjd,bhnje->bhnde", kw, vs)).astype(f32)
    return y


def emulate(q, k, v, ld, u, C, scalar):
    """The kernel's schedule at chunk C: (y (B, S, H, Dv), final state)."""
    S = q.shape[1]
    n = -(-S // C)
    qc, kc, vc, lc = (_chunks(a, n, C) for a in (q, k, v, ld))
    dS, g = chunk_states(kc, vc, lc, C)
    starts, final = pass_over_chunks(dS, g)
    y = outputs(qc, kc, vc, lc, u, starts, scalar)
    y = y.transpose(0, 2, 3, 1, 4).reshape(B, n * C, H, DV)[:, :S]
    return y, final


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("C", [64, 128, KERNEL_CHUNK])
@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_reference(jax_results, name, C):
    """The emulated kernel (y, final state) against the Pallas kernel in
    interpret mode and the exact sequential scan; chunks of 128 and 256
    put two and four tiles in a chunk (the state passed between tiles) and
    leave the last chunk part empty."""
    S, _, scalar, _ = CASES[name]
    q, k, v, ld, u = _inputs(name)
    y, final = emulate(q, k, v, ld, u, C, scalar)
    y_pallas, y_ex, st_ex, _ = jax_results[name]
    assert np.isfinite(y).all() and np.isfinite(final).all()
    if y_pallas is not None:
        _close(y, y_pallas, TOL)
    _close(y, y_ex, EXACT_TOL if CASES[name][3] else TOL)
    _close(final, st_ex, TOL)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[0] % CHUNK == 0])
def test_final_state_matches_closed_form(jax_results, name):
    """The emulated kernel's final state against the reference wrapper's
    closed form (clamped at -30; the clamp moves a term by under e^-30
    times |k||v|), within FINAL_TOL."""
    S, _, scalar, _ = CASES[name]
    q, k, v, ld, u = _inputs(name)
    _, final = emulate(q, k, v, ld, u, KERNEL_CHUNK, scalar)
    _close(final, jax_results[name][3], FINAL_TOL)


def test_suffix_weights_never_exceed_one():
    """Every exponent the schedule takes is <= 0: the chunk-state weights
    and g lie in [0, 1] even under -30 |N| decays, where a factorised
    exp(cum) . exp(-cum) would overflow fp32."""
    q, k, v, ld, u = _inputs("mamba2-scalar-extreme")
    n = -(-q.shape[1] // KERNEL_CHUNK)
    kc, vc, lc = (_chunks(a, n, KERNEL_CHUNK) for a in (k, v, ld))
    assert (-np.cumsum(lc, axis=3)).max() > 88  # exp(-cum) would overflow
    ones = np.ones_like(kc)
    w, g = chunk_states(ones, np.ones_like(vc[..., :1]), lc, KERNEL_CHUNK)
    assert np.isfinite(w).all() and (w >= 0).all() \
        and (w <= KERNEL_CHUNK).all()
    assert np.isfinite(g).all() and (g >= 0).all() and (g <= 1).all()
