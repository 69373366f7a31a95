"""Model-layout (B, S, H, D*) chunked GLA scan: the recurrent mixers'
no-cache scan when ``kernel="cuda"`` — the port's counterpart of
``repro.kernels.ssm_scan.ops.ssm_scan``, with its contract: from zero
state only, returning (y, final_state).

Where the tensors lie picks the implementation, nothing else does: CUDA
tensors launch the hand-written kernel (csrc/ssm_scan.cu, built with nvcc
on first use), which also writes the final state; CPU tensors run the
plain PyTorch version (ref.py) and rebuild the final state in closed form
(clamped at -30, as the reference does).  Anything else raises — there is
no fallback from the kernel.  ``ssm_scan.launches`` counts the calls that
reach the kernel; each issues ``device_kernels()`` device kernels (the
chunks' states, the pass over chunks, the outputs).  The kernel's state
is the same recurrence without the clamp: a term the clamp changes is
below e^-30 (9.4e-14) times |k||v|.

The kernel reads q, k, v and ld through their strides as given: stride-0
views (Mamba2's q/k broadcast over heads, its ld broadcast over Dk) are
passed without a copy.  ld and u are read as float32: an ld of another
dtype is cast (a copy), and u is cast to a contiguous float32 (H, Dk).
The chunks' states go to scratch allocated here with ``torch.empty`` (its
size from the shapes alone), so a call can be captured in a CUDA graph.
Unlike the JAX wrapper, S need not be a multiple of the chunk.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu",)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DK = (32, 64, 128)
MAX_GRID_YZ = 65535  # heads and batch ride the grid's y and z axes
CLAMP = -30.0        # the closed-form final state's exponent floor


def bind(lib):
    """Declare the C interface of a loaded build of csrc/ssm_scan.cu
    (tools/scan_chunk_tiles.py binds its variants with it)."""
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.ssm_scan_chunk_rows.argtypes = []
        lib.ssm_scan_chunk_rows.restype = ctypes.c_int
        lib.ssm_scan_device_kernels.argtypes = []
        lib.ssm_scan_device_kernels.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    return bind(_build.load("ssm_scan", SOURCES))


def device_kernels() -> int:
    """Device kernels one call of the CUDA kernel issues."""
    return _lib().ssm_scan_device_kernels()


def _validate(q, k, v, ld, u, state, chunk):
    if state is not None:
        raise ValueError("ssm_scan starts from zero state (state=None); a "
                         "carried state takes gla_chunked's plain route")
    if q.ndim != 4 or k.shape != q.shape or ld.shape != q.shape \
            or v.ndim != 4 or v.shape[:3] != q.shape[:3] or q.shape[1] == 0:
        raise ValueError(
            f"ssm_scan takes q/k/ld (B, S, H, Dk) and v (B, S, H, Dv) with "
            f"S >= 1; got q {tuple(q.shape)}, k {tuple(k.shape)}, ld "
            f"{tuple(ld.shape)}, v {tuple(v.shape)}")
    H, Dk = q.shape[2], q.shape[3]
    if u is not None and tuple(u.shape) != (H, Dk):
        raise ValueError(f"u must be (H, Dk) = ({H}, {Dk}); got "
                         f"{tuple(u.shape)}")
    if chunk < ref.SUB or chunk % ref.SUB:
        raise ValueError(f"chunk={chunk} must be a multiple of the "
                         f"{ref.SUB}-row sub-chunk")
    tensors = [q, k, v, ld] + ([] if u is None else [u])
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"ssm_scan: every tensor must lie on {dev}; got "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan runs on CUDA (the kernel) or the CPU "
                         f"(its plain version); got {dev}")


def _launch(q, k, v, ld, u, lib=None):
    """Check what the CUDA kernel takes, launch it on the current stream,
    raise if the launch was refused.  Returns (y, final state).  `lib`
    defaults to this package's build."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes q, k, v of one dtype in "
                         f"{tuple(KERNEL_DTYPES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if Dk not in KERNEL_DK:
        raise ValueError(f"the CUDA kernel takes Dk in {KERNEL_DK}; got {Dk}")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"the CUDA kernel takes at most {MAX_GRID_YZ} "
                         f"heads and batch rows; got H={H}, B={B}")
    if ld.dtype != torch.float32:
        ld = ld.float()
    uf = None if u is None else u.float().contiguous()
    if lib is None:
        lib = _lib()
    n_chunks = -(-S // lib.ssm_scan_chunk_rows())
    dev = q.device
    y = torch.empty(B, S, H, Dv, dtype=v.dtype, device=dev)
    states = torch.empty(B * H * n_chunks * Dk * Dv, dtype=torch.float32,
                         device=dev)
    decay = torch.empty(B * H * n_chunks * Dk, dtype=torch.float32,
                        device=dev)
    state = torch.empty(B, H, Dk, Dv, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *ld.stride())
    rc = lib.ssm_scan_launch(
        KERNEL_DTYPES[q.dtype], Dk, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ld.data_ptr(), None if uf is None else uf.data_ptr(), y.data_ptr(),
        states.data_ptr(), decay.data_ptr(), state.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), B, S, H, Dv, int(u is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: "
                           f"{lib.ssm_scan_error_string(rc).decode()} ({rc})")
    return y, state


def final_state(k, v, ld):
    """The scan's final state from zero state, in closed form:
    sum_t (k_t o exp(max(total - cum_t, -30)))^T v_t, cum the inclusive
    cumsum of ld over the sequence.  (B, H, Dk, Dv) float32."""
    cum = torch.cumsum(ld.float(), dim=1)
    total = cum[:, -1]                               # (B, H, Dk)
    k_carry = k.float() * torch.exp(torch.clamp(total[:, None] - cum,
                                                min=CLAMP))
    return torch.einsum("bshk,bshv->bhkv", k_carry, v.float())


def ssm_scan(q, k, v, ld, u=None, state=None, chunk: int = 64):
    """q/k/ld: (B, S, H, Dk), v: (B, S, H, Dv), u: (H, Dk) or None (None:
    Mamba2 mode, y_t reads s_t; given: bonus mode, y_t reads s_{t-1} plus
    the u-bonus).  ``state`` must be None.  ``chunk`` is the reference's
    chunk (a multiple of 16), checked and otherwise unused: the plain
    version walks 16-row sub-chunks and the kernel its own chunks whatever
    it is, and any S is taken.

    Returns (y (B, S, H, Dv) in v's dtype, final_state (B, H, Dk, Dv)
    float32): on the card both from the kernel, on the CPU the closed-form
    state."""
    _validate(q, k, v, ld, u, state, chunk)
    if q.device.type == "cpu":
        y = ref.reference_scan(q, k, v, ld, u=u)
        return y, final_state(k, v, ld)
    y, state = _launch(q, k, v, ld, u)
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0
