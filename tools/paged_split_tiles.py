#!/usr/bin/env python3
"""Time the paged-attention kernel
(src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu) with
other warp counts and ring splits, on one NVIDIA GPU:

    python3 tools/paged_split_tiles.py

Each variant is a copy of the source with some of its tile constants
replaced (kWarps, warps per CTA; kRows, query rows per CTA;
kKeysPerRound, keys a lane group loads before it uses any), built with the
port's nvcc flags, all copies at once, into the build directory (listed in
.gitignore).  Each build is run with every
pages_per_split in PAGES (16 = the whole ring of 16 pages in one CTA: no
split, no merge) at chip_smoke.py's two serving shapes of qwen3_0_6b (H=16,
KV=8, hd=128, 16 pages of 16, bf16 q, fp32 pool): the decode tick B=4, S=1
at the positions of the serving run's busiest tick, and the prefill chunk
B=1, S=16, last=47.  Each (variant, split) is checked against the plain
version (output within chip_smoke.BF16_TOL, pools bit-equal outside the
null page) and timed by CUDA-graph replay in two rounds, the second in
reverse order.  Prints ptxas's lines per variant, one line per (shape,
variant, split) and round, and the card's name and power limit.  Exits
non-zero without a CUDA device or if a variant disagrees.

Then where a decode launch's time goes: a 1-element elementwise kernel
(what a graph node costs at least); the shipped build without the scatter
(attention only) and with every slot at position 0; and copies of the
shipped source cut short at each step of the kernel (a `return` before the
step's comment, behind a test of `window` that the compiler cannot fold,
so nothing before it is optimised away).  These copies write no output and
are timed, not checked.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# name: {constant: value} replaced in the source ("w4": as shipped)
VARIANTS = {"w4": {}, "w8": {"kWarps": 8}, "w4_rows2": {"kRows": 2},
            "w4_keys1": {"kKeysPerRound": 1}}
# cut short before the step whose comment starts so (the kernel's steps)
CUTS = {"loads": "  // 2. scatter the new rows",
        "scatter+test": "  if (any) {\n    // 4.",
        "kv-loads": "      // the scores of every (row, key) pair",
        "round": "    // 5. merge the key groups",
        "attention": "  // 6. this CTA's result",
        "partial": "  // 7. the last CTA"}
PAGES = (1, 2, 4, 16)
# chip_smoke.py's serving shapes; the decode tick's positions are those of
# the busiest tick of its serving run
SHAPES = [("decode", dict(B=4, S=1, lasts=[51, 50, 62, 73])),
          ("prefill", dict(B=1, S=16, lasts=[47]))]


def build(_build, src_text):
    """One shared library per variant and per cut, all nvcc processes at
    once.  Returns ({variant: lib}, {cut: lib})."""
    import re
    out_dir = os.path.join(_build.BUILD_DIR, "paged_tiles")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, consts in VARIANTS.items():
        text = src_text
        for const, value in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if k != 1:
                raise RuntimeError(f"tile constant not found: {const}")
        texts[name] = text
    for name, marker in CUTS.items():
        texts[name] = src_text.replace(
            marker, "  if (a.window != -12345) return;\n" + marker, 1)
    for name in CUTS:
        if texts[name] == src_text:
            raise RuntimeError(f"marker not found for {name}")
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name.replace('+', '_')}.cu")
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
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(so)
    return ({name: libs[name] for name in VARIANTS},
            {name: libs[name] for name in CUTS})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_split_tiles: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops, ref

    card = cs.card_line()
    with open(ops.SOURCES[0]) as f:
        libs, cuts = build(_build, f.read())
    libs = {name: ops.bind(lib) for name, lib in libs.items()}
    cuts = {name: ops.bind(lib) for name, lib in cuts.items()}
    cfg = get_config("qwen3_0_6b")
    full = dict(H=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.head_dim, psz=16,
                P=16, n_pages=1 + 4 * 16, q_dtype=torch.bfloat16,
                pool_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = [(v, pps) for v in VARIANTS for pps in PAGES]
    ok = True
    for shape, kw in SHAPES:
        q, kn, vn, kp, vp, bt, last = cs.paged_inputs(gen, **full, **kw)
        for rnd, order in enumerate((variants, variants[::-1])):
            for w, pps in order:
                def call(kp=kp, vp=vp):
                    return ops._launch(q, kn, vn, kp, vp, bt, last, None, 0,
                                       lib=libs[w], pages_per_split=pps)
                kp2, vp2 = kp.clone(), vp.clone()
                kp3, vp3 = kp.clone(), vp.clone()
                out = call(kp3, vp3)
                want, _, _ = ref.reference_paged_update(q, kn, vn, kp2, vp2,
                                                        bt, last)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                same = torch.equal(kp3[1:], kp2[1:]) and torch.equal(
                    vp3[1:], vp2[1:])
                ok &= err <= cs.BF16_TOL and same and bool(
                    torch.isfinite(out).all())
                ms = cs.time_ms(call)
                print(f"paged {shape} (B={kw['B']}, S={kw['S']}, lasts="
                      f"{kw['lasts']}) {w} pages_per_split={pps} "
                      f"round {rnd + 1} [{card}]: {ms:.4f} ms, max_abs_err "
                      f"{err:.3g}, pools equal {same}")
    # what a launch costs apart from the pages: one 1-element elementwise
    # kernel (a graph node's floor); the shipped build without the scatter
    # (attention only) and with every slot at position 0 (one admitted key)
    one = torch.zeros(1, device="cuda")
    print(f"floor: one 1-element add_ [{card}]: "
          f"{cs.time_ms(lambda: one.add_(1)):.4f} ms")
    q, kn, vn, kp, vp, bt, last = cs.paged_inputs(gen, **full, **SHAPES[0][1])
    lib, pps = libs["w4"], ops.PAGES_PER_SPLIT
    for what, args in (("attention only", (q, None, None, kp, vp, bt, last)),
                       ("fused, all lasts 0", (q, kn, vn, kp, vp, bt,
                                               torch.zeros_like(last)))):
        ms = cs.time_ms(lambda: ops._launch(*args, None, 0, lib=lib,
                                            pages_per_split=pps))
        print(f"paged decode {what} w4 pages_per_split={pps} "
              f"[{card}]: {ms:.4f} ms")
    for name, cut in cuts.items():
        ms = cs.time_ms(lambda: ops._launch(q, kn, vn, kp, vp, bt, last,
                                            None, 0, lib=cut,
                                            pages_per_split=pps))
        print(f"paged decode cut after {name} w4 "
              f"pages_per_split={pps} [{card}]: {ms:.4f} ms")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
