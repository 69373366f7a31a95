"""Model-layout (B, S, H, hd) GQA flash attention: the no-cache forward's
attention when ``kernel="cuda"`` — the port's counterpart of
``repro.kernels.flash_attention.ops.flash_attention``, with the same
contract (causal by default, optional sliding window and chunked-local
masks, fp32 softmax, output in q's dtype).

Where the tensors lie picks the implementation, nothing else does: CUDA
tensors launch a hand-written kernel (built with nvcc on first use); CPU
tensors run the plain PyTorch version (ref.py).  Anything else raises —
there is no fallback from the kernels.  On the card the inputs' type picks
the kernel: bf16 runs the tensor-core kernel (csrc/flash_attention_tc.cu:
wgmma on TMA-fed tiles), fp32 the CUDA-core kernel
(csrc/flash_attention.cu).  ``flash_attention.launches`` counts the
launches of both; ``launches_tensor_core`` and ``launches_cuda_core``
count each kernel's, as the launch reports which one it ran.

Unlike the JAX wrapper, K/V are not repeated over the query heads (the
kernel reads KV head h // g itself) and S need not be a multiple of the
block size (the kernel masks the ragged edge).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_tc.cu")
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 80, 128)
MAX_GRID_YZ = 65535  # heads and batch ride the grid's y and z axes


def _lib():
    lib = _build.load("flash_attention", SOURCES)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.c_float, P, ctypes.POINTER(I)]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _validate(q, k, v, window, chunk):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention takes q (B, S, H, hd) and matching k/v "
            f"(B, S, KV, hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or S == 0:
        raise ValueError(
            f"k/v must be (B, S, KV, hd) = ({B}, {S}, KV, {hd}) with S >= 1; "
            f"got {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} query heads must group onto KV="
                         f"{k.shape[2]} heads (GQA)")
    if window < 0 or chunk < 0:
        raise ValueError(f"window and chunk must be >= 0; got {window}, "
                         f"{chunk}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash attention: q, k and v must lie on one "
                         f"device; got {q.device}, {k.device}, {v.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on CUDA (the kernel) or the "
                         f"CPU (its plain version); got {dev}")


def _launch(q, k, v, causal, window, chunk):
    """Check what the CUDA kernels take, launch one on the current stream,
    raise if the launch was refused.  Returns the output and whether the
    launch reported the tensor-core kernel (else the CUDA-core one)."""
    B, S, H, hd = q.shape
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes q, k, v of one dtype in "
                         f"{tuple(KERNEL_DTYPES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}; got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel reads q, k, v in the contiguous "
                         "model layout (B, S, heads, hd)")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"the CUDA kernel takes at most {MAX_GRID_YZ} "
                         f"heads and batch rows; got H={H}, B={B}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel reads q, k, v with TMA, which "
                         "needs 16-byte aligned base addresses")
    out = torch.empty_like(q)
    lib = _lib()
    variant = ctypes.c_int(-1)
    rc = lib.flash_attention_launch(
        KERNEL_DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, k.shape[2], int(bool(causal)), int(window),
        int(chunk), 1.0 / float(hd) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(variant))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
    return out, variant.value == 1


def flash_attention(q, k, v, *, causal=True, window=0, chunk=0):
    """q: (B, S, H, hd), k/v: (B, S, KV, hd) with H = g*KV (GQA), all
    already RoPE'd.  Position i of the sequence attends to position j when
    j <= i (causal), j > i - window (window > 0) and j // chunk == i //
    chunk (chunk > 0).  Returns (B, S, H, hd) in q's dtype."""
    _validate(q, k, v, window, chunk)
    if q.device.type == "cpu":
        return ref.reference_attention(q, k, v, causal=causal, window=window,
                                       chunk=chunk).to(q.dtype)
    out, tensor_core = _launch(q, k, v, causal, window, chunk)
    flash_attention.launches += 1
    if tensor_core:
        flash_attention.launches_tensor_core += 1
    else:
        flash_attention.launches_cuda_core += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tensor_core = 0
flash_attention.launches_cuda_core = 0
