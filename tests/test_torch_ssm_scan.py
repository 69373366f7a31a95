"""PyTorch port vs the JAX reference: the chunked GLA scan (CPU, small
shapes).

The port's ``ssm_scan`` runs its plain version (the kernel's 16-row
sub-chunked arithmetic) on CPU tensors.  It is held against JAX's Pallas
kernel in interpret mode, y and the closed-form final state, in both modes;
the two compute the same sub-chunks in fp32 and differ only in summation
order, so 1e-4 (relative and absolute) holds with room to spare — the
reference's own kernel test allows 1e-3 against the exact scan.  A ragged
S (which the reference kernel does not take) and the extreme decay are
held against the exact sequential scan at the reference's 1e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssm_scan import ops as j_ss  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ss  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ss_ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = 1e-4
EXACT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, B, S, H, Dk, Dv, bonus, decay=None):
    """q, k, v, ld, u as float32 numpy arrays: ld = -softplus(N(0, 1)), or
    -decay * |N(0, 1)| (the reference's extreme-decay test)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v, z = f(B, S, H, Dk), f(B, S, H, Dk), f(B, S, H, Dv), f(B, S, H, Dk)
    ld = (-np.abs(z) * decay if decay else -np.logaddexp(z, 0)) \
        .astype(np.float32)
    u = np.abs(f(H, Dk)) if bonus else None
    return q, k, v, ld, u


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,Dk,Dv,bonus,decay", [
    (2, 256, 2, 64, 64, False, None),
    (1, 128, 2, 64, 128, True, None),
    (1, 128, 2, 32, 32, False, 30.0),    # extreme decay
    (1, 128, 2, 32, 32, True, 30.0),
])
def test_ssm_scan_matches_jax_kernel(B, S, H, Dk, Dv, bonus, decay):
    """y and the final state within TOL, except under the extreme decay:
    there a sub-chunk's cumsum reaches |cum| ~ 400 (one fp32 ulp 3e-5),
    and the closed-form state's cumsum over the whole sequence |cum| ~
    3000 (ulp 2.4e-4); the two packages sum those cumsums in another order,
    which moves the exponents, and so y and the state relatively, by up to
    a few 1e-4 (the bonus mode's cum - ld cancels to the same size).  Both
    are held at the reference's own 1e-3 there."""
    q, k, v, ld, u = _inputs(S + Dk + Dv, B, S, H, Dk, Dv, bonus, decay)
    want_y, want_st = j_ss.ssm_scan(q, k, v, ld, u=u, chunk=64)
    n = ss.ssm_scan.launches
    y, st = ss.ssm_scan(*map(_t, (q, k, v, ld, u)))
    assert ss.ssm_scan.launches == n  # the CPU runs no kernel
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = EXACT_TOL if decay else TOL
    _close(y, want_y, tol)
    _close(st, want_st, tol)


@pytest.mark.parametrize("S,bonus,decay", [(100, False, None),
                                           (37, True, None),
                                           (45, True, 30.0)])
def test_ssm_scan_ragged_s_matches_exact_scan(S, bonus, decay):
    """Any S: the wrapper's y and final state against the port's and the
    reference's exact sequential scan."""
    q, k, v, ld, u = _inputs(S, 2, S, 2, 32, 32, bonus, decay)
    want_y, want_st = JS.gla_scan_exact(q, k, v, ld, u=u)
    y, st = ss.ssm_scan(*map(_t, (q, k, v, ld, u)))
    ye, ste = TS.gla_scan_exact(*map(_t, (q, k, v, ld, u)))
    _close(ye, want_y, TOL)
    _close(ste, want_st, TOL)
    _close(y, want_y, EXACT_TOL)
    _close(st, want_st, EXACT_TOL)


@pytest.mark.parametrize("S,bonus,carry", [(96, False, False),
                                           (90, True, False),
                                           (64, True, True)])
def test_gla_chunked_plain_route_matches_jax(S, bonus, carry):
    """gla_chunked's plain route (chunk 16, shrunk until it divides S: 90
    takes chunks of 15) against the reference's use_pallas=False route, a
    carried state included."""
    q, k, v, ld, u = _inputs(S + 1, 2, S, 2, 16, 32, bonus)
    st0 = (np.random.default_rng(0).normal(size=(2, 2, 16, 32))
           .astype(np.float32) if carry else None)
    want_y, want_st = JS.gla_chunked(q, k, v, ld, u=u, state=st0)
    y, st = TS.gla_chunked(*map(_t, (q, k, v, ld, u)), state=_t(st0))
    _close(y, want_y, TOL)
    _close(st, want_st, TOL)


def test_gla_chunked_kernel_route_matches_jax_pallas():
    """kernel="cuda" (its plain version on the CPU) against the reference's
    use_pallas=True route at the default chunk (max(16, 64) = 64)."""
    q, k, v, ld, u = _inputs(5, 1, 128, 2, 64, 64, True)
    want_y, want_st = JS.gla_chunked(q, k, v, ld, u=u, use_pallas=True)
    y, st = TS.gla_chunked(*map(_t, (q, k, v, ld, u)), kernel="cuda")
    _close(y, want_y, TOL)
    _close(st, want_st, TOL)


def test_reference_scan_pads_to_sub_chunks():
    """The plain version at a ragged S equals the same rows of a run on a
    zero-padded sequence (a padded row adds nothing)."""
    q, k, v, ld, u = map(_t, _inputs(9, 1, 40, 2, 32, 32, True))
    y = ss_ref.reference_scan(q, k, v, ld, u=u)
    y48, _ = ss_ref.chunked_scan(*(torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, 8)) for a in (q, k, v, ld)), u=u)
    assert torch.equal(y, y48[:, :40])


def test_ssm_scan_validates():
    q, k, v, ld, _ = map(_t, _inputs(1, 1, 32, 2, 32, 32, False))
    with pytest.raises(ValueError):      # the kernel starts from zero
        ss.ssm_scan(q, k, v, ld, state=torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError):      # not a multiple of 16
        ss.ssm_scan(q, k, v, ld, chunk=24)
    with pytest.raises(ValueError):      # u of the wrong shape
        ss.ssm_scan(q, k, v, ld, u=torch.zeros(3, 32))
    with pytest.raises(ValueError):      # ld of another shape
        ss.ssm_scan(q, k, v, ld[:, :16])
    with pytest.raises(ValueError):
        TS.gla_chunked(q, k, v, ld, kernel="pallas")
