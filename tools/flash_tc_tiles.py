#!/usr/bin/env python3
"""Time the bf16 tensor-core flash-attention kernel
(src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu) with
other tile sizes, on one NVIDIA GPU:

    python3 tools/flash_tc_tiles.py

Each variant is a copy of the source with its two tile constants replaced
(kBK, keys per block: 64 or 128; kStages, the K/V ring's depth), built
with the port's nvcc flags, all variants at once, into the build directory
(listed in .gitignore).  Each is checked against the plain version at the
prefill shapes (bf16 tolerance 1e-2, as in chip_smoke.py) and timed by
CUDA-graph replay in two rounds, the second in reverse order.  Prints
ptxas's lines per variant, one line per (shape, variant) and round, and
the card's name and power limit.  Exits non-zero without a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

VARIANTS = {"bk128_s2": (128, 2), "bk128_s3": (128, 3),
            "bk64_s2": (64, 2), "bk64_s4": (64, 4)}
# (name, B, S, H, KV, hd): qwen3_0_6b's and zamba2_2_7b's prefill, and hd 64
SHAPES = [("qwen3_0_6b", 2, 2048, 16, 8, 128),
          ("zamba2_2_7b", 2, 2048, 32, 32, 80),
          ("hd64", 2, 2048, 16, 8, 64)]


def build(_build, src_text):
    """One shared library per variant, all nvcc processes at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (bk, stages) in VARIANTS.items():
        text = src_text
        for old, new in (
                ("constexpr int kBK = 128;", f"constexpr int kBK = {bk};"),
                ("constexpr int kStages = 2;",
                 f"constexpr int kStages = {stages};")):
            if old not in text:
                raise RuntimeError(f"tile constant not found: {old}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_tc_launch.argtypes = [
            I, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, P]
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_tc_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    card = cs.card_line()
    with open(fops.SOURCES[1]) as f:
        libs = build(_build, f.read())

    def launch(lib, q, k, v, out):
        B, S, H, hd = q.shape
        rc = lib.flash_attention_tc_launch(
            hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
            S, H, k.shape[2], 1, 0, 0, hd ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape, B, S, H, KV, hd in SHAPES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda")
                   .bfloat16() for n in (H, KV, KV))
        want = fref.reference_attention(q, k, v).float()
        for rnd, names in enumerate((list(libs), list(reversed(libs)))):
            for name in names:
                out = torch.empty_like(q)
                launch(libs[name], q, k, v, out)
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                ok &= err <= cs.BF16_TOL
                ms = cs.time_ms(lambda: launch(libs[name], q, k, v, out),
                                iters=10, reps=5)
                print(f"{shape} (B={B}, S={S}, H={H}, KV={KV}, hd={hd}) "
                      f"{name} round {rnd + 1} [{card}]: {ms:.4f} ms, "
                      f"max_abs_err {err:.3g}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
