"""Versions of the keys and pose kernels side by side on one card, in turns.

    python3 tools/keys_pose_ab.py [DIR ...]    (default: legkilo_torch/csrc)

Each DIR holds a version of ``match_geom.cu`` and ``pose_prop.cu`` (and the
headers they include).  For each version the tool builds one library of the
two sources with nvcc (the flags of ops/_build.py) and prints ptxas's
registers, spills and stack frame for each keys and pose kernel in it.  It
holds the version's keys kernel against ``keys_plain`` (C = 3584 / L = 3,
C = 300 / L = 2: keys, centres and probe starts exact, p_i/p_w rel 1e-6,
covariances rel 1e-5) and its pose kernel against ``pose_plain`` (MP = 128,
256, 384 and 1,280: bit-equal), and says whether each output is
``torch.equal`` to the first version's.  Then it times every version with
CUDA events (chip_smoke.time_call, 200 launches a turn) in turns, first to
last and last to first, at the main path's shapes (keys at C = 3584 / L = 3,
pose at MP = 128) and at pose's MP = 256, 384 and 1,280, beside the library's
empty kernel (the launch floor).  Give a parent's ``legkilo_torch/csrc``
unpacked under ``build/`` as the first DIR for a before/after.  Builds go
to build/keys_pose_ab/ (git-ignored).  Needs one card and nvcc; compare
two versions only inside one run.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from legkilo_torch.ops import _build  # noqa: E402
from legkilo_torch.ops import match_geom as mg  # noqa: E402
from legkilo_torch.ops import pose_prop as pp  # noqa: E402

OUT = os.path.join(ROOT, "build", "keys_pose_ab")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
POSE_SHAPES = {128: (28, 1), 256: (28, 5), 384: (28, 12), 1280: (256, 4)}
KEYS_SHAPES = ((3584, 3), (300, 2))
TIMED = ("keys_c3584_l3", "pose_mp128", "pose_mp256", "pose_mp384", "pose_mp1280")


def batch_args(d, name, entry):
    """[1] where this version's C entry point takes the fleet's replica
    count (``int batch``: a version with the replica axis), else []."""
    with open(os.path.join(d, name)) as fh:
        src = fh.read()
    sig = src[src.index(f"LK_API int {entry}("):]
    return [1] if "int batch" in sig[: sig.index(")")] else []


def build(tag, d):
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{tag}.so")
    cmd = [NVCC] + _build.NVCC_FLAGS + ["-shared", "-Xptxas", "-v", "-I", d,
                                        os.path.join(d, "match_geom.cu"), os.path.join(d, "pose_prop.cu"), "-o", so]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(text):
    """(kernel, 'N registers, S B of spills, F B stack') for each keys/pose kernel."""
    out, lines = [], text.splitlines()
    for n, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or not re.search(r"keys_kernel|pose", m.group(1)):
            continue
        body = []
        for nxt in lines[n + 1:]:
            if "Compiling entry function" in nxt:
                break
            body.append(nxt)
        body = "\n".join(body)
        regs, stack = (sum(int(x) for x in re.findall(pat, body))
                       for pat in (r"Used (\d+) registers", r"(\d+) bytes stack frame"))
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", body))
        name = re.search(r"\d+(keys_kernel|pose_kernel)(ILi\d+E)?", m.group(1))
        out.append((name.group(1) + (f"<{name.group(2)[3:-1]}>" if name.group(2) else ""),
                    f"{regs} registers, {spills} B of spills, {stack} B stack"))
    return out


def main():
    dirs = sys.argv[1:] or [os.path.join(ROOT, "legkilo_torch", "csrc")]
    # A version's tag: the directory above its legkilo_torch/csrc.
    tags = [f"v{i}_{os.path.abspath(d).split(os.sep)[-3]}" for i, d in enumerate(dirs)]
    print(f"[card] {cs.card_line()}", flush=True)
    procs = [(tag, *build(tag, d)) for tag, d in zip(tags, dirs)]
    libs, extra = {}, {}
    for (tag, so, p), d in zip(procs, dirs):
        text, _ = p.communicate()
        if p.returncode:
            print(f"[ab] build {tag} FAILED\n{text}")
            return 1
        for name, info in ptxas_lines(text):
            print(f"[ab] {tag} {name}: {info}")
        lib = ctypes.CDLL(so)
        extra[tag] = (batch_args(d, "match_geom.cu", "keys_launch"),
                      batch_args(d, "pose_prop.cu", "pose_launch"))
        lib.keys_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * (3 + len(extra[tag][0]))
                                    + [ctypes.c_void_p])
        lib.pose_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (1 + len(extra[tag][1]))
                                    + [ctypes.c_void_p])
        libs[tag] = lib
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cases = {}
    for c, levels in KEYS_SHAPES:
        kargs = cs.keys_inputs(torch, dev, np.random.default_rng(7), c=c, levels=levels)
        outs = [torch.empty((6, c), device=dev), torch.empty((27, c), device=dev),
                torch.empty((6 * levels, c), dtype=torch.int32, device=dev),
                torch.empty((6 * levels, c), device=dev), torch.empty((2 * levels, c), dtype=torch.int32, device=dev)]

        def run(tag, kargs=kargs, outs=outs, c=c, levels=levels):
            rc = libs[tag].keys_launch(*[t.data_ptr() for t in list(kargs) + outs], c, levels, 1 << 14,
                                       *extra[tag][0], stream())
            assert rc == 0, rc
            return outs

        def check(got, ref):
            return (all(torch.equal(got[i], ref[i]) for i in (2, 3, 4))
                    and cs.rel_err(got[0], ref[0]) <= 1e-6 and cs.rel_err(got[1], ref[1]) <= 1e-5)

        cases[f"keys_c{c}_l{levels}"] = (run, mg.keys_plain(*kargs, levels, 1 << 14), check)
    for mp, (nb, k) in POSE_SHAPES.items():
        pargs = cs.pose_inputs(torch, dev, np.random.default_rng(mp), nb, k)
        out = torch.empty((12, mp), device=dev)

        def run(tag, pargs=pargs, out=out, mp=mp):
            rc = libs[tag].pose_launch(pargs[0].data_ptr(), pargs[1].data_ptr(), out.data_ptr(), mp,
                                       *extra[tag][1], stream())
            assert rc == 0, rc
            return [out]

        cases[f"pose_mp{mp}"] = (run, [pp.pose_plain(*pargs)], lambda got, ref: torch.equal(got[0], ref[0]))

    ok = True
    for name, (run, ref, check) in cases.items():
        first = None
        for tag in tags:
            got = [x.clone() for x in run(tag)]
            torch.cuda.synchronize()
            good = check(got, ref)
            same = first is None or all(torch.equal(a, b) for a, b in zip(got, first))
            first = got if first is None else first
            print(f"[ab] {name} {tag}: {'OK' if good else 'FAIL'} against the plain version; "
                  f"torch.equal to {tags[0]}: {same}", flush=True)
            ok = ok and good
    if not ok:
        return 1

    empty = _build._function("lk_empty_launch", 0, 0)
    floor = lambda: empty(stream())  # noqa: E731
    ms = {(n, t): [] for n in TIMED for t in tags + ["floor"]}
    for order in (tags, tags[::-1]):
        for name in TIMED:
            ms[(name, "floor")].append(cs.time_call(torch, floor, 200))
            for tag in order:
                ms[(name, tag)].append(cs.time_call(torch, lambda: cases[name][0](tag), 200))
    for name in TIMED:
        row = "  ".join(f"{t} {np.mean(ms[(name, t)]):.5f} ({', '.join(f'{x:.5f}' for x in ms[(name, t)])})"
                        for t in tags + ["floor"])
        print(f"[ab] {name}: ms a launch (CUDA events, turns): {row}", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
