#!/usr/bin/env python3
"""Time the GreedyTL Gram kernel
(src/repro_torch/kernels/greedy_scores/csrc/greedy_scores.cu) with other
register tiles and pipeline depths, on one NVIDIA GPU:

    python3 tools/gram_tiles.py

Each variant is a copy of the source with its tile constants replaced
(kTM x kTN, a thread's register tile; kStages, the steps of Z's rows in
flight; kRows, the rows of Z per step), built with the port's nvcc flags, all variants at once, into the
build directory (listed in .gitignore).  Each is checked against the plain
version at the HAPT shape (B=252, m=365, n=583) and two ragged ones (G
bit-equal to the plain version's and bit-symmetric) and timed at the HAPT
shape by CUDA-graph replay in two rounds, the second in reverse order,
beside one torch.bmm; then copies of the shipped source cut short (no
staging after the pipeline's first steps, no products, no stores) are
timed, to show where the time goes; so is the shipped source with
streaming stores of G (__stcs) in place of plain ones (checked too).
Prints ptxas's lines and the kernel's most frequent
SASS opcodes per variant, one line per variant and round, the shipped
variant's time over about two seconds with the SM clock and power that
nvidia-smi read meanwhile, and the card's name and power limit.  Exits non-zero
without a CUDA device or if a variant disagrees.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# name: (kTM, kTN, kStages, kRows); the first as shipped
VARIANTS = {"tm8_tn8_s4_r16": (8, 8, 4, 16), "tm8_tn8_s3_r16": (8, 8, 3, 16),
            "tm8_tn8_s3_r32": (8, 8, 3, 32), "tm16_tn8_s4_r16": (16, 8, 4, 16)}
# the shipped source with one piece of code replaced (checked and timed)
ALTERNATIVES = {
    "streaming stores of G": (
        "void store_g(float* p, float v) { *p = v; }",
        "void store_g(float* p, float v) { __stcs(p, v); }")}
# copies of the shipped source cut short (timed, not checked): the step's
# code stays, behind a runtime test on m the compiler cannot fold
CUTS = {
    "no staging past the first steps": (
        "    if (ahead < steps) stage(",
        "    if (ahead < steps && m < 0) stage("),
    "no products": (
        "    const float* As = smem + (s % kStages) * kStageFloats;\n",
        "    if (m > 0) continue;\n"
        "    const float* As = smem + (s % kStages) * kStageFloats;\n"),
    "no stores": (
        "  // the tile through shared memory: G's rows, then the mirror's",
        "  if (m > 0) return;\n"
        "  // the tile through shared memory: G's rows, then the mirror's"),
}
SHAPES = [(252, 365, 583), (3, 37, 45), (2, 33, 300)]


def sass_mix(_build, name, so):
    """The gram kernel's most frequent SASS opcodes (static counts, the
    whole kernel), where the toolkit has cuobjdump."""
    from collections import Counter
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "gram_kernel" in line
        elif inside and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            ops[op.split(".")[0]] += 1
    print(f"  SASS {name}: {sum(ops.values())} instructions, "
          f"{ops.most_common(12)}")


def build(_build, src_text):
    """One shared library per variant, all nvcc processes at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "gram_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs, texts = {}, {}
    for name, (old, new) in {**ALTERNATIVES, **CUTS}.items():
        if old not in src_text:
            raise RuntimeError(f"code to replace not found: {old}")
        texts[name] = src_text.replace(old, new, 1)
    for name, (tm, tn, stages, rows) in VARIANTS.items():
        text = src_text
        for old, new in (
                ("constexpr int kTM = 8, kTN = 8;",
                 f"constexpr int kTM = {tm}, kTN = {tn};"),
                ("constexpr int kStages = 4;",
                 f"constexpr int kStages = {stages};"),
                ("constexpr int kRows = 16;",
                 f"constexpr int kRows = {rows};")):
            if old not in text:
                raise RuntimeError(f"tile constant not found: {old}")
            text = text.replace(old, new)
        texts[name] = text
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               cu[:-3] + ".so", cu]
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if name not in CUTS:
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
            sass_mix(_build, name, so)
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.greedy_gram_launch.argtypes = [P, P, I, I, I, P]
        libs[name] = lib
    return ({name: libs[name] for name in (*VARIANTS, *ALTERNATIVES)},
            {name: libs[name] for name in CUTS})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gram_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.greedy_scores import ops as gops
    from repro_torch.kernels.greedy_scores import ref as gref

    card = cs.card_line()
    with open(gops.SOURCES[0]) as f:
        libs, cuts = build(_build, f.read())

    def gram(lib, Z):
        B, m, n = Z.shape
        G = torch.empty(B, n, n, device="cuda")
        rc = lib.greedy_gram_launch(Z.data_ptr(), G.data_ptr(), B, m, n,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")
        return G

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, m, n in SHAPES:
        Z = torch.randn(B, m, n, generator=gen, device="cuda") / m ** 0.5
        want = gref.reference_gram(Z)
        for name, lib in libs.items():
            G = gram(lib, Z)
            torch.cuda.synchronize()
            same, sym = torch.equal(G, want), torch.equal(G, G.mT)
            ok &= same and sym
            print(f"gram {name} (B={B}, m={m}, n={n}): bit-equal to the "
                  f"plain version {same}, bit-symmetric {sym}")
    B, m, n = cs.HAPT_B, cs.HAPT_M, cs.HAPT_N
    Z = torch.randn(B, m, n, generator=gen, device="cuda") / m ** 0.5
    flop = B * m * n * (n + 1)
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            ms = cs.time_ms(lambda: gram(libs[name], Z), iters=5, reps=4)
            print(f"gram (B={B}, m={m}, n={n}) {name} round {rnd + 1} "
                  f"[{card}]: {ms:.4f} ms, {flop / ms * 1e-9:.1f} TFLOP/s "
                  f"of the minimal count")
        ms = cs.time_ms(lambda: torch.bmm(Z.mT, Z), iters=5, reps=4)
        print(f"torch.bmm round {rnd + 1} [{card}]: {ms:.4f} ms")
    for name, lib in cuts.items():
        ms = cs.time_ms(lambda: gram(lib, Z), iters=5, reps=4)
        print(f"gram (B={B}, m={m}, n={n}) shipped, cut: {name} [{card}]: "
              f"{ms:.4f} ms")
    # the SM clock and power while the shipped variant runs for ~2 s
    import threading
    samples, running = [], [True]

    def sample():
        while running[0]:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
    sampler = threading.Thread(target=sample)
    sampler.start()
    shipped = names[0]
    ms = cs.time_ms(lambda: gram(libs[shipped], Z), iters=10, reps=200)
    running[0] = False
    sampler.join()
    clocks = sorted(c for c, _ in samples)
    power = sorted(p for _, p in samples)
    print(f"gram {shipped} over ~2 s [{card}]: {ms:.4f} ms; SM clock MHz "
          f"median {clocks[len(clocks) // 2]:.0f} (min {clocks[0]:.0f}, max "
          f"{clocks[-1]:.0f}), power W median {power[len(power) // 2]:.1f}, "
          f"{len(samples)} samples")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
