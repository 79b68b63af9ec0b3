"""Where the select kernel spends its cycles, on the card.

    python3 tools/select_phases.py [DIR ...]    (default: legkilo_torch/csrc)

Each DIR holds a version of ``match_geom.cu`` (the keys and select
kernels).  For each version it builds two libraries with nvcc: the source
as it is, and a copy in which thread 0 of every block of ``select_kernel``
reads clock64() at the end of each phase and adds the cycles since the last
stamp to the phase's count:

- ``scan``: the ordered ballot/popc scan over bidx, each step up to its
  second barrier;
- ``cand``: each row-pass round's candidate step (with the selection
  step's loads issued ahead of it), up to the barrier after it;
- ``select``: each round's selection step (and the next round's barrier);
- ``sums``: the sums, the match count and the write-back of the outputs,
  up to the barrier that ends the group (the slowest of the three roles);
- ``rest``: from the scan to the first round, and from the last group to
  the block's own stores;

and, inside ``sums``, the cycles to the barrier of thread 0 (a tile of the
sums), of the count warp's lane 0 and of the last thread (a writer).

It prints ptxas's registers and spills, holds both copies against
``select_plain`` with chip_smoke's tolerances on the rows and the sums,
times the versions with CUDA events in turns (each version's plain copy,
then again in the reverse order), and prints the cycles a block by phase
(mean and max over the bucket blocks, max over the blocks for the rows in
no bucket) at the main path's shape (C = 3584, L = 3, NB = 28) and at the
2 ms bucket shape (NB = 56).  A stamp costs a few dozen cycles; the stamps
are placed by matching lines of the source, and a version without them
fails.  Builds and each version's SASS (``sass_<version>.txt``) go to
build/select_phases/ (git-ignored).  Needs one card and nvcc; compare two
versions only inside one run.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from legkilo_torch.ops import match_geom as mg  # noqa: E402

OUT = os.path.join(ROOT, "build", "select_phases")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
PHASES = ("scan", "cand", "select", "sums", "rest")
NSLOT = 10  # stamps a block: the five phases, the block's total cycles, the three roles of ``sums``

ST = "if (threadIdx.x == 0) { const long long n_ = clock64(); ph_[{k}] += n_ - t_last_; t_last_ = n_; }"


def stamp(src: str) -> str:
    """The source with clock64() stamps in select_kernel (see the docstring);
    thread 0 keeps them in shared memory at namespace scope."""
    def sub(old, new):
        if src.count(old) != 1:
            raise RuntimeError(f"select_phases: the source no longer has exactly one {old!r}")
        return src.replace(old, new)

    st = lambda k: ST.replace("{k}", str(k))  # noqa: E731
    src = sub("// The row pass over sh.rows[0..n_rows), 64 rows a round.",
              "__shared__ long long ph_[8];\n__shared__ long long t_last_;\n__shared__ long long role_[3];\n"
              "// The row pass over sh.rows[0..n_rows), 64 rows a round.")
    src = sub("float* __restrict__ nm, int n_buckets",
              "float* __restrict__ nm, long long* __restrict__ stamps, int n_buckets")
    src = sub("  extern __shared__ __align__(16) unsigned char select_smem[];\n",
              "  extern __shared__ __align__(16) unsigned char select_smem[];\n"
              "  const long long t0_ = clock64();\n"
              "  if (threadIdx.x == 0) { for (int k = 0; k < 8; ++k) ph_[k] = 0; t_last_ = t0_; "
              "role_[0] = role_[1] = role_[2] = 0; }\n")
    src = sub("    __syncthreads();\n    const int end = total + sh.step_total;",
              "    __syncthreads();\n    " + st(0) + "\n    const int end = total + sh.step_total;")
    src = sub("    if (i0 > 0) __syncthreads();  // the last round's records are read",
              "    if (i0 > 0) __syncthreads();  // the last round's records are read\n"
              "    if (i0 > 0) { " + st(2) + " } else { " + st(4) + " }")
    src = sub("sh.rows[i0 + ic]);\n    }\n    __syncthreads();\n",
              "sh.rows[i0 + ic]);\n    }\n    __syncthreads();\n    " + st(1) + "\n")
    src = sub("    select_rows(a, sh, n_rows);\n    __syncthreads();",
              "    select_rows(a, sh, n_rows);\n    __syncthreads();\n    " + st(2)
              + "\n    const long long t_role_ = clock64();")
    src = sub("    __syncthreads();\n  };",
              "    { const long long d_ = clock64() - t_role_; if (threadIdx.x == 0) role_[0] += d_;\n"
              "      if (threadIdx.x == kCountWarp * 32) role_[1] += d_; if (threadIdx.x == kThreads - 1) role_[2] += d_; }\n"
              "    __syncthreads();\n    " + st(3) + "\n  };")
    src = sub("  if (!bucket_block) return;",
              "  " + st(4) + "\n  if (threadIdx.x == 0) {\n"
              f"    for (int k = 0; k < 5; ++k) stamps[blockIdx.x * {NSLOT} + k] = ph_[k];\n"
              f"    stamps[blockIdx.x * {NSLOT} + 5] = clock64() - t0_;\n"
              f"    for (int k = 0; k < 3; ++k) stamps[blockIdx.x * {NSLOT} + 6 + k] = role_[k];\n  }}\n"
              "  if (!bucket_block) return;")
    src = sub("float* nm, int C,", "float* nm, long long* stamps, int C,")
    src = sub("(a, bidx, s40, nm, n_buckets", "(a, bidx, s40, nm, stamps, n_buckets")
    return src


def build(tag, d, stamped):
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(d, "match_geom.cu")).read()
    # keys_launch out, select_launch renamed: the probe launches as the port does.
    src = src[: src.index("LK_API int keys_launch")] + src[src.index("LK_API int select_launch"):]
    src = src.replace("LK_API int select_launch(", "LK_API int probe_launch(")
    takes_batch = "int n_buckets, int batch," in src  # a version with the fleet's replica axis
    if stamped:
        src = stamp(src)
    path = os.path.join(OUT, f"{tag}_{'stamped' if stamped else 'plain'}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = path[:-3] + ".so"
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-Xptxas", "-v", "-I", d, "-I", os.path.join(ROOT, "legkilo_torch", "csrc"), path, "-o", so]
    return so, takes_batch, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    dirs = sys.argv[1:] or [os.path.join(ROOT, "legkilo_torch", "csrc")]
    tags = [f"v{i}_{os.path.basename(os.path.normpath(d))}" for i, d in enumerate(dirs)]
    print(f"[card] {cs.card_line()}", flush=True)
    procs = [(tag, stamped, *build(tag, d, stamped)) for tag, d in zip(tags, dirs) for stamped in (False, True)]
    libs = {}
    batch_arg = {}
    for tag, stamped, so, takes_batch, p in procs:
        batch_arg[tag] = [1] if takes_batch else []
        text, _ = p.communicate()
        if p.returncode:
            print(f"[phases] build {tag} stamped={stamped} FAILED\n{text}")
            return 1
        lines = text.splitlines()
        for n, ln in enumerate(lines):
            if "Compiling entry" in ln and "select_kernel" in ln:
                info = [x.strip() for x in lines[n + 1:n + 4] if "Used" in x or "spill" in x]
                print(f"[phases] {tag} stamped={stamped}: {' | '.join(info)}")
        if not stamped:  # the SASS of the version, beside the builds
            with open(os.path.join(OUT, f"sass_{tag}.txt"), "w") as fh:
                subprocess.run([os.path.join(os.path.dirname(NVCC), "cuobjdump"), "-sass", so], stdout=fh,
                               stderr=subprocess.STDOUT)
        lib = ctypes.CDLL(so)
        lib.probe_launch.argtypes = ([ctypes.c_void_p] * (11 + stamped)
                                     + [ctypes.c_int] * (3 + len(batch_arg[tag])) + [ctypes.c_void_p])
        libs[(tag, stamped)] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    kargs = cs.keys_inputs(torch, dev, rng)
    kout = mg.keys_call(*kargs, 3, 1 << 14)
    for nb in (28, 56):
        sargs = cs.select_inputs(torch, dev, rng, kout, nb=nb)
        c = sargs[1].shape[1]
        grid = nb + c  # at least the blocks of any version: a version's own grid is smaller
        stamps = torch.zeros(grid * NSLOT, dtype=torch.int64, device=dev)
        outs = (torch.empty((46, c), device=dev), torch.empty((nb * 40, 40), device=dev),
                torch.empty((nb, 128), device=dev))

        def run(tag, stamped):
            ptrs = [t.data_ptr() for t in list(sargs) + list(outs)] + ([stamps.data_ptr()] if stamped else [])
            rc = libs[(tag, stamped)].probe_launch(*ptrs, c, 3, nb, *batch_arg[tag],
                                                   torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        ref = mg.select_plain(*sargs, 3, nb)
        for tag in tags:
            for stamped in (False, True):
                run(tag, stamped)
                torch.cuda.synchronize()
                same = outs[0][0] == ref[0][0]
                e_rows = cs.rel_err(outs[0][:, same], ref[0][:, same])
                e_s40, nm_same = cs.select_sums_vs_plain(torch, *outs, *ref, sargs[7], nb)
                ok = float(same.float().mean()) >= 0.999 and e_rows <= 1e-4 and e_s40 <= 1e-4 and nm_same
                print(f"[phases] NB = {nb} {tag} stamped={stamped}: {'OK' if ok else 'FAIL'} "
                      f"flips {int((~same).sum())} rows {e_rows:.1e} s40 {e_s40:.1e} counts {nm_same}")
                if not ok:
                    return 1
        ms = {tag: [] for tag in tags}
        for order in (tags, tags[::-1]):
            for tag in order:
                ms[tag].append(cs.time_call(torch, lambda: run(tag, False), 200))
        for tag in tags:
            stamps.zero_()
            run(tag, True)
            torch.cuda.synchronize()
            st = stamps.view(grid, NSLOT).double().cpu().numpy()
            bk, orph = st[:nb], st[nb:][st[nb:, len(PHASES)] > 0]
            ph = "  ".join(f"{p} {bk[:, k].mean():.0f}/{bk[:, k].max():.0f}" for k, p in enumerate(PHASES))
            tot = len(PHASES)
            print(f"[phases] NB = {nb} {tag}: {np.mean(ms[tag]):.5f} ms a call (CUDA events, turns "
                  f"{', '.join(f'{x:.5f}' for x in ms[tag])}); bucket blocks, cycles mean/max: {ph}  "
                  f"total {bk[:, tot].mean():.0f}/{bk[:, tot].max():.0f}; orphan blocks max total "
                  f"{orph[:, tot].max():.0f} (cand {orph[:, 1].max():.0f}, select {orph[:, 2].max():.0f}); "
                  f"in sums, cycles mean/max: a tile thread {bk[:, 6].mean():.0f}/{bk[:, 6].max():.0f}, "
                  f"the count warp {bk[:, 7].mean():.0f}/{bk[:, 7].max():.0f}, "
                  f"a writer {bk[:, 8].mean():.0f}/{bk[:, 8].max():.0f}", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
