"""Model-layout (B, S, H, hd) paged attention over the shared page pool:
attention only (`paged_attention`) and fused scatter + attention
(`paged_attention_update`, the serving decode and prefill path).

The port's counterpart of ``repro.kernels.paged_attention.ops``, with the
same eligibility rules, raised as ``ValueError`` with the same wording:

- block_table / last_pos / q_positions must already be int32;
- q is (B, S, H, hd) with H a multiple of the pool's KV head count and
  1 <= S <= P * page_size.

Where the tensors lie picks the implementation, nothing else does: CUDA
tensors launch the hand-written kernel (csrc/paged_attention.cu, built
with nvcc on first use); CPU tensors run the plain PyTorch version
(ref.py).  Anything else raises — there is no fallback from the kernel.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernel splits each slot's ring over CTAs, PAGES_PER_SPLIT
block-table entries each, and merges the splits' partial softmax results
in the same launch (the last CTA of each slot and KV head to finish does
it, counted by tickets).  The wrapper allocates the partials' scratch with
``torch.empty``, its size from the shapes alone, and keeps one zeroed
ticket buffer per CUDA stream (the kernel leaves it zeroed; a launch under
graph capture gets tickets of its own, from a pool zeroed beforehand), so
launches on two streams at once never share tickets.  It reads nothing
from the device, so a call can be captured in a CUDA graph.  Default
query positions are
computed in the kernel, not by the wrapper.  The kernel moves 16 bytes
at a time, so on the card q, k_new, v_new and the pools must start
16-byte aligned (every fresh tensor does).

The pools are updated IN PLACE (the JAX wrappers returned new, aliased
pools): the kernel writes the S new rows into the tensors it was given.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "paged_attention.cu",)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)
# block-table entries per CTA of the ring's split
# (tools/paged_split_tiles.py times the choices)
PAGES_PER_SPLIT = 2


def _validate(q, k_pool, v_pool, block_table, last_pos, q_positions):
    if q.ndim != 4:
        raise ValueError(
            f"paged attention takes q (B, S, H, hd); got shape "
            f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    if k_pool.shape != v_pool.shape or k_pool.ndim != 4:
        raise ValueError(
            f"k_pool/v_pool must be matching (n_pages, page_size, KV, hd) "
            f"pools; got {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    KV = k_pool.shape[2]
    if H % KV:
        raise ValueError(
            f"H={H} query heads must group onto KV={KV} pool heads (GQA)")
    for name, arr in (("block_table", block_table), ("last_pos", last_pos)):
        if arr.dtype != torch.int32:
            raise ValueError(
                f"{name} must be int32 at construction (got {arr.dtype}); "
                f"the engine owns block tables and positions as int32 — "
                f"per-dispatch astype casts were removed, not hidden")
    if q_positions is not None and (
            q_positions.dtype != torch.int32
            or tuple(q_positions.shape) != (B, S)):
        raise ValueError(
            f"q_positions must be (B, S) int32; got "
            f"{tuple(q_positions.shape)} {q_positions.dtype}")
    T = block_table.shape[1] * k_pool.shape[1]
    if not 1 <= S <= T:
        raise ValueError(
            f"S={S} query block must satisfy 1 <= S <= ring length {T} "
            f"(P * page_size) — larger blocks would overwrite their own "
            f"tokens and are ineligible for the kernel")


def bind(lib):
    """Declare the C interface of a loaded build of csrc/paged_attention.cu
    (tools/paged_split_tiles.py binds its variants with it)."""
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, P, P, P, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
        lib.paged_attention_scratch_floats.argtypes = [I] * 7
        lib.paged_attention_scratch_floats.restype = ctypes.c_longlong
        lib.paged_attention_max_tickets.argtypes = []
        lib.paged_attention_max_tickets.restype = ctypes.c_int
        lib.paged_attention_tickets.argtypes = [I] * 7
        lib.paged_attention_tickets.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


_tickets: dict = {}  # (device, stream handle) -> the stream's ticket buffer
# zeroed tickets cut, a launch's worth at a time, for launches captured in a
# CUDA graph (allocated beside a device's first stream buffer)
CAPTURE_POOL_TICKETS = 1 << 20
_capture_pool: dict = {}  # device index -> [zeroed int32 buffer, next free]


def _stream_tickets(lib, dev, stream, need):
    """The zeroed uint32 tickets of a splitting launch on `stream` (at
    least `need`): one buffer per (device, stream), kept zeroed by the
    kernel.  A launch under graph capture gets tickets of its own, so that
    the graph's replays never meet an eager launch's: cut from a pool
    zeroed beforehand (the graph then holds no fill of its own), or a
    fresh zeroed buffer once the pool is spent."""
    if torch.cuda.is_current_stream_capturing():
        pool = _capture_pool.get(dev.index)
        if pool is not None and pool[1] + need <= pool[0].numel():
            buf = pool[0][pool[1]:pool[1] + need]
            pool[1] += need
            return buf
        return torch.zeros(need, dtype=torch.int32, device=dev)
    key = (dev.index, stream.cuda_stream)
    buf = _tickets.get(key)
    if buf is None:
        buf = _tickets[key] = torch.zeros(
            lib.paged_attention_max_tickets(), dtype=torch.int32, device=dev)
        if dev.index not in _capture_pool:
            _capture_pool[dev.index] = [torch.zeros(
                CAPTURE_POOL_TICKETS, dtype=torch.int32, device=dev), 0]
    return buf


def _launch(q, k_new, v_new, k_pool, v_pool, block_table, last_pos,
            q_positions, window, lib=None, pages_per_split=None):
    """Check what the CUDA kernel takes, launch it on the current stream,
    raise if the launch was refused.  `lib` and `pages_per_split` default
    to this package's build and PAGES_PER_SPLIT."""
    B, S, H, hd = q.shape
    dev = q.device
    tensors = [q, k_pool, v_pool, block_table, last_pos]
    tensors += [t for t in (q_positions, k_new, v_new) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("paged attention: every tensor must lie on "
                         f"{dev}; got {[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype not in KERNEL_DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(
            f"the CUDA kernel takes q and pools in {tuple(KERNEL_DTYPES)}; "
            f"got q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    if k_new is not None and (k_new.dtype != q.dtype
                              or v_new.dtype != q.dtype):
        raise ValueError(f"k_new/v_new must be {q.dtype} like q; got "
                         f"{k_new.dtype}/{v_new.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}; got {hd}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the pools are written in place and must be "
                         "contiguous")
    q = q.contiguous()
    if k_new is not None:
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
    block_table = block_table.contiguous()
    last_pos = last_pos.contiguous()
    if q_positions is not None:
        q_positions = q_positions.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool, k_new, v_new)
           if t is not None):
        raise ValueError("the CUDA kernel reads and writes 16 bytes at a "
                         "time: q, k_new, v_new and the pools must start "
                         "16-byte aligned")
    out = torch.empty_like(q)
    if lib is None:
        lib = bind(_build.load("paged_attention", SOURCES))
    pps = pages_per_split or PAGES_PER_SPLIT
    KV, P = k_pool.shape[2], block_table.shape[1]
    n_scratch = lib.paged_attention_scratch_floats(B, S, H, KV, hd, P, pps)
    stream = torch.cuda.current_stream(dev)
    scratch = tickets = None
    if n_scratch:
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
        need = lib.paged_attention_tickets(B, S, H, KV, hd, P, pps)
        tickets = _stream_tickets(lib, dev, stream, need)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.paged_attention_launch(
        KERNEL_DTYPES[q.dtype], KERNEL_DTYPES[k_pool.dtype], hd, ptr(q),
        ptr(k_new), ptr(v_new), ptr(k_pool), ptr(v_pool), ptr(block_table),
        ptr(q_positions), ptr(last_pos), ptr(out), ptr(scratch),
        ptr(tickets), B, S, H, KV, k_pool.shape[1], P, int(window), pps,
        1.0 / float(hd) ** 0.5, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: "
            f"{lib.paged_attention_error_string(rc).decode()} ({rc})")
    return out


def _dispatch(wrapper, q, k_new, v_new, k_pool, v_pool, block_table,
              last_pos, window, q_positions):
    _validate(q, k_pool, v_pool, block_table, last_pos, q_positions)
    if q.device.type == "cpu":
        if k_new is None:
            return ref.reference_paged_attention_block(
                q, k_pool, v_pool, block_table, last_pos, window=window,
                q_positions=q_positions)
        out, _, _ = ref.reference_paged_update(
            q, k_new, v_new, k_pool, v_pool, block_table, last_pos,
            window=window, q_positions=q_positions)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on CUDA (the kernel) or "
                         f"the CPU (its plain version); got {q.device}")
    out = _launch(q, k_new, v_new, k_pool, v_pool, block_table, last_pos,
                  q_positions, window)
    wrapper.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, block_table, last_pos, *,
                    window: int = 0, q_positions=None):
    """q: (B, S, H, hd) with H = g*KV (GQA) — an S-token query block per
    slot, already RoPE'd; its K/V must already be in the pool (use
    `paged_attention_update` to fuse that write in).

    k_pool/v_pool: (n_pages, page_size, KV, hd) shared pools.
    block_table: (B, P) int32 page ids; last_pos: (B,) int32 absolute
    position of the newest token per slot.  q_positions: optional (B, S)
    int32 per-row query positions (defaults to last_pos - S + 1 ..
    last_pos, the contiguous decode block).  Returns (B, S, H, hd)."""
    return _dispatch(paged_attention, q, None, None, k_pool, v_pool,
                     block_table, last_pos, window, q_positions)


def paged_attention_update(q, k_new, v_new, k_pool, v_pool, block_table,
                           last_pos, *, window: int = 0, q_positions=None):
    """Fused scatter + attention: the serving decode/prefill path.

    k_new/v_new: (B, S, KV, hd) just-projected K/V rows for positions
    last_pos - S + 1 .. last_pos; they are written into their
    block-table-addressed page rows (cast to the pool dtype) in place,
    then the query block attends over the pools.  Returns
    (out, k_pool, v_pool): out (B, S, H, hd) and the pools that were
    passed, now holding the new rows."""
    B, S = q.shape[:2]
    want = (B, S) + tuple(k_pool.shape[2:])
    if tuple(k_new.shape) != want or k_new.shape != v_new.shape:
        raise ValueError(
            f"k_new/v_new must be (B, S, KV, hd) = {want}; got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    out = _dispatch(paged_attention_update, q, k_new, v_new, k_pool,
                    v_pool, block_table, last_pos, window, q_positions)
    return out, k_pool, v_pool


paged_attention.launches = 0
paged_attention_update.launches = 0
