#!/usr/bin/env python3
"""Time the chunked GLA scan kernel
(src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu) with other chunk and
tile sizes, and where a call's time goes, on one NVIDIA GPU:

    python3 tools/scan_chunk_tiles.py

Each variant is a copy of the source with some of its constants replaced
(kChunk, the rows whose state is passed between chunks; kTile, the rows
of the chunk-state kernel's tile), built with the port's nvcc flags, all
copies at once, into the build directory (listed in .gitignore).  Each is
checked against the plain version at both main-path shapes (y within
chip_smoke.SCAN_BF16_TOL, the final state within SCAN_STATE_TOL) and
timed by CUDA-graph replay in two rounds, the second in reverse order, at
zamba2's shape (B=2, S=2048, H=80, Dk=Dv=64, bf16, stride-0 q/k/ld) and
rwkv6's (H=64, bonus mode).  Then copies of the shipped source that launch
only some of the call's three device kernels (kPhases: the chunks'
states, the pass over chunks, the outputs), some of them with one step of
a kernel skipped, are timed, not checked, to show where the time goes.
Prints ptxas's lines per variant, one line per (variant, shape) and
round, the cut-short times, and the card's name and power limit.  Exits
non-zero without a CUDA device or if a variant disagrees.
"""
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# name: {constant: value} replaced in the source ("c256": as shipped;
# kTile: the chunk-state kernel's rows per tile)
VARIANTS = {"c256": {}, "c512": {"kChunk": 512}, "c128": {"kChunk": 128},
            "c64": {"kChunk": 64}, "c256_t64": {"kTile": 64}}
# copies of the shipped source that launch only some of its kernels (the
# bits of kPhases: 1 the chunks' states, 2 the pass, 4 the outputs), some
# with one step of a kernel skipped: the code from the first marker up to
# the second runs only under a test of `bonus` that never holds and that
# the compiler cannot fold
CUTS = {
    "chunk states only": (1, None),
    "pass only": (2, None),
    "outputs only": (4, None),
    "chunk states without the weights": (1, (
        "    // w_j = exp(sum of ld over the chunk's rows after j) <= 1: each",
        "#pragma unroll 4\n    for (int j = 0; j < kTile; ++j) {")),
    "chunk states without the product": (1, (
        "#pragma unroll 4\n    for (int j = 0; j < kTile; ++j) {",
        "  const long long chunk = bh_index(a, b, h) * a.n_chunks + c;\n"
        "  float* out = a.states")),
    "outputs without widening the staged tile": (4, (
        "    if (q_async) widen_rows",
        "    // each sub-chunk's own inclusive cumsum of ld, per channel")),
    "outputs without A": (4, (
        "    // A[i][j], j <= i, of each sub-chunk",
        "    for (int e = tid; e < R * DK; e += kThreads) {  // in place")),
    "outputs without the factors": (4, (
        "    for (int e = tid; e < R * DK; e += kThreads) {  // in place",
        "    // the states at sub-chunks 1 .. G-1")),
    "outputs without the states": (4, (
        "    for (int s = 1; s <= G; ++s) {",
        "    __syncthreads();\n\n    // y: thread (half, yi, tj)")),
    "outputs without y": (4, (
        "    // y: thread (half, yi, tj)",
        "    if (carry) {\n      __syncthreads();  // every thread has read ST[0]")),
}
SHAPES = [("zamba2_2_7b", 80, True), ("rwkv6_7b", 64, False)]


def build(_build, src_text):
    """One shared library per copy, all nvcc processes at once.  Returns
    ({variant: lib}, {cut: lib})."""
    out_dir = os.path.join(_build.BUILD_DIR, "scan_tiles")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, consts in VARIANTS.items():
        text = src_text
        for const, value in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if k != 1:
                raise RuntimeError(f"constant not found: {const}")
        texts[name] = text
    for name, (bits, marker) in CUTS.items():
        text, k = re.subn(r"constexpr unsigned kPhases = \d+;",
                          f"constexpr unsigned kPhases = {bits};", src_text)
        if k != 1:
            raise RuntimeError("kPhases not found")
        if marker is not None and marker[0].startswith("replace"):
            for old, new in zip(marker[1::2], marker[2::2]):
                if text.count(old) != 1:
                    raise RuntimeError(f"code not found once for {name}")
                text = text.replace(old, new)
        elif marker is not None:
            begin, end = marker
            i = text.find(begin)
            j = text.find(end, i)
            if text.count(begin) != 1 or text.count(end) != 1 or j < 0:
                raise RuntimeError(f"markers not found once for {name}")
            text = (text[:i] + "    if (a.bonus == -7) {\n" + text[i:j]
                    + "    }\n" + text[j:])
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               cu[:-3] + ".so", cu]
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if name in VARIANTS:
            fn = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    fn = line if "I13__nv_bfloat16Li64E" in line \
                        or "pass_kernel" in line else None
                elif fn and ("registers" in line or "spill" in line):
                    kern = re.search(r"\d+(\w+?_kernel)", fn).group(1)
                    print(f"  ptxas {name} {kern}: {line.strip()}")
        libs[name] = ctypes.CDLL(so)
    return ({name: libs[name] for name in VARIANTS},
            {name: libs[name] for name in CUTS})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_chunk_tiles: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    card = cs.card_line()
    with open(sops.SOURCES[0]) as f:
        libs, cuts = build(_build, f.read())
    libs = {name: sops.bind(lib) for name, lib in libs.items()}
    cuts = {name: sops.bind(lib) for name, lib in cuts.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S = cs.PREFILL_B, cs.PREFILL_S
    inputs = {arch: cs._scan_inputs(gen, B, S, H, 64, 64, torch.bfloat16,
                                    bonus=not mamba, mamba=mamba)
              for arch, H, mamba in SHAPES}
    ok = True
    for arch, (q, k, v, ld, u) in inputs.items():
        want = sref.reference_scan(q, k, v, ld, u=u)
        _, want_st = sref.chunked_scan(q, k, v, ld, u=u)
        for name, lib in libs.items():
            y, st = sops._launch(q, k, v, ld, u, lib=lib)
            torch.cuda.synchronize()
            err = ((y.float() - want.float()).abs()
                   / (1 + want.float().abs())).max().item()
            s_err = ((st - want_st).abs() / (1 + want_st.abs())).max().item()
            good = err <= cs.SCAN_BF16_TOL and s_err <= cs.SCAN_STATE_TOL
            ok &= good
            print(f"ssm_scan {name} {arch}: worst |err| / (1 + |want|) y "
                  f"{err:.3g}, state {s_err:.3g}: "
                  f"{'ok' if good else 'DISAGREES'}")
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            for arch, args in inputs.items():
                ms = cs.time_ms(lambda: sops._launch(*args, lib=libs[name]),
                                iters=10, reps=5)
                print(f"ssm_scan {name} {arch} round {rnd + 1} [{card}]: "
                      f"{ms:.4f} ms")
    for name, lib in cuts.items():
        for arch, args in inputs.items():
            ms = cs.time_ms(lambda: sops._launch(*args, lib=lib), iters=10,
                            reps=5)
            print(f"ssm_scan shipped, {name} ({lib.ssm_scan_device_kernels()}"
                  f" kernels) {arch} [{card}]: {ms:.4f} ms")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
