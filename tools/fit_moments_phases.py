"""Where the moments and refit kernels spend their cycles, on the card.

    python3 tools/fit_moments_phases.py [DIR]    (default: legkilo_torch/csrc)

DIR holds a version of ``insert_rows.cu`` and ``plane_fit_rows.cu`` that
reads its rows by index (``moments_rows_launch`` / ``fit_slots_launch``).
The tool builds a copy of the two sources in which one thread of every
block reads clock64() at the kernel's entry and at the end of each phase, after
a use of the values the phase loaded, so a stamp falls after they arrive:

- moments: ``index`` (the row's indices), ``point`` (the point's rows and
  its bucket index), ``compute`` (the bucket's rows through L1 and the
  row's 69 values), ``tile`` (into shared memory and the barrier),
  ``store`` (a full tile's stores issued);
- fit, seen from a contraction lane (lane 7 of the first slot): ``fs``
  (the slot's row index), ``row`` (the row's 70 floats into shared
  memory), ``t`` (its share of t), ``wait`` (at the barrier, for the eigen
  warp; the barrier defers its blocking, so the stamp after it reads a
  value the eigen warp wrote), ``w_u`` and ``c`` (the split contraction's phases), ``out`` (its
  last plane_var store issued); and, in a second copy, from the eigen
  warp's lane 0: ``fs``, ``row`` (its 16 values), ``eigen``, ``hand_over``
  (its values into shared memory and the barrier), ``head`` (the row's
  uncontracted values stored).

The stamps are placed by matching lines of the source, and a version
without those lines fails.  It prints ptxas's registers and spills and the
cycles a block by phase (mean and max over the blocks) on chip_smoke's
inputs at the main path's shapes (R 4,096 / NB 28; B 1,024 from a short
run's map), and the kernel's time by CUDA events for the copy with stamps
and the library's own build, in turns.  A stamp costs a few dozen cycles.
Builds go to build/fit_moments_phases/ (git-ignored).  Needs one card and
nvcc.
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
from legkilo_torch.ops import _build  # noqa: E402
from legkilo_torch.ops import insert_rows as ir  # noqa: E402
from legkilo_torch.ops import plane_fit_rows as pfr  # noqa: E402

OUT = os.path.join(ROOT, "build", "fit_moments_phases")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
MAX_BLOCKS = 4096
STAMP_DEFS = """
__device__ long long lk_stamps[{blocks} * 8];
__device__ int lk_sink;
#define LK_STAMP(i) if (threadIdx.x == {stamper}) lk_stamps[blockIdx.x * 8 + (i)] = clock64();
#define LK_USE(x) if ((x) == -12345) lk_sink = 1;
extern "C" __attribute__((visibility("default"))) int lk_read_stamps(long long* host) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, lk_stamps, sizeof(lk_stamps)));
}}
"""
# (phase names, the thread that stamps, [(source line, text inserted after
# it[, which of the lines that read so])]) for each kernel.
MOMENTS = (["index", "point", "compute", "tile", "store"], "0", [
    ("  const int r = min(r0 + lane, a.R - 1);", "  LK_STAMP(0)"),
    ("  const float sz = a.sizes[lv];", "  LK_USE(p + ikey[2]) LK_STAMP(1)"),
    ("  for (int k = 0; k < 9; ++k) bc[k] = a.bcov[p * a.bc_sr + k * a.bc_sc];",
     "  LK_USE(bc[8] + pi[2] + (float)bi + sz) LK_STAMP(2)"),
    ("  float* om = s_mom + lane * kMomW;", "  LK_USE(v6[5] + m2[5] + prel[2]) LK_STAMP(3)"),
    ("  const float4* ss4 = reinterpret_cast<const float4*>(s_moms);", "  LK_STAMP(4)"),
    ("    for (int j = 0; j < kMoms4 / kRows; ++j) gs[lane + kRows * j] = vs[j];", "    LK_STAMP(5)"),
])
# fit, from lane 7 of the first slot's contraction lanes (thread 39), which
# runs every contraction phase, and from the eigen warp's lane 0.
FIT = (["fs", "row", "t", "wait", "w_u", "c", "out"], "39", [
    ("  const bool live = slot < B;  // a dead slot of the last block computes slot B - 1 and stores nothing",
     "  LK_STAMP(0)"),
    ("  const long long row = fs[min(slot, B - 1)];", "  LK_USE(row) LK_STAMP(1)", 1),
    ("  auto mr = [&](int i) { return F(S.in[i]); };", "  LK_STAMP(2)"),
    ("  eigen_done();", "  LK_STAMP(3)", 1, "before"),
    ("  eigen_done();", "  LK_USE(S.alpha[0]) LK_STAMP(4)", 1),
    ("  // c_ij = sum_{a,b} b_i[a,b] w_j[b,a]", "  LK_STAMP(5)"),
    ("  // The upper triangle of the 6x6 [[t_nn, t_nq], [t_nq^T, s0 / n^2]], zeroed", "  LK_STAMP(6)"),
    ("    if (live) o[10 + tri6(r_, c_)] = (x * is_plane_f).v;", "    LK_STAMP(7)"),
])
FIT_EIGEN = (["fs", "row", "eigen", "hand_over", "head"], "0", [
    ("  const bool live = threadIdx.x < kSlots && slot < B;", "  LK_STAMP(0)"),
    ("  const long long row = fs[min(slot, B - 1)];", "  LK_USE(row) LK_STAMP(1)", 0),
    ("  auto mr = [&](int i) { return in[i]; };", "  LK_USE(in[14].v + in[8].v) LK_STAMP(2)"),
    ("  if (threadIdx.x < 2 * kSlots) {", "  LK_USE(v_min[2].v + v_max[2].v + is_plane_f.v) LK_STAMP(3)", 0,
     "before"),
    ("  eigen_done();", "  LK_STAMP(4)", 0),
    ("  o[34] = is_plane_f.v;", "  LK_STAMP(5)"),
])
KERNELS = (("moments", "insert_rows.cu", MOMENTS), ("fit", "plane_fit_rows.cu", FIT),
           ("fit_eigen", "plane_fit_rows.cu", FIT_EIGEN))


def instrument(src_dir, name, spec):
    """The source with LK_STAMP / LK_USE inserted after the spec's lines."""
    with open(os.path.join(src_dir, name)) as f:
        lines = f.read().split("\n")
    for anchor, text, *where in spec[2]:
        # An anchor names one line, or (with where[0]) that one of the lines
        # that read so; the text goes after it, or (where[1]) before it.
        hits = [i for i, ln in enumerate(lines) if ln == anchor]
        nth = where[0] if where else 0
        if len(hits) <= nth or (not where and len(hits) != 1):
            raise RuntimeError(f"{name}: {len(hits)} lines read {anchor!r}; this version has no place for a stamp")
        lines.insert(hits[nth] + (0 if where[1:] == ["before"] else 1), text)
    body = "\n".join(lines)
    head = body.index('#include "lk_common.cuh"')
    defs = STAMP_DEFS.format(blocks=MAX_BLOCKS, stamper=spec[1])
    return body[:head] + '#include "lk_common.cuh"\n' + defs + body[head + len('#include "lk_common.cuh"'):]


def build(src_dir, tag, name, spec):
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(instrument(src_dir, name, spec))
    so = cu[:-3] + ".so"
    cmd = [NVCC] + _build.NVCC_FLAGS + ["-shared", "-Xptxas", "-v", "-I", src_dir, cu, "-o", so]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode:
        raise RuntimeError(f"build of the stamped {name} failed:\n{out.stdout}")
    for ln in out.stdout.splitlines():
        if "Used" in ln or "spill" in ln:
            print(f"[phases] stamped {tag}: {ln.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    lib.lk_read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def report(tag, lib, phases, n_blocks):
    host = np.zeros(MAX_BLOCKS * 8, np.int64)
    torch.cuda.synchronize()
    if lib.lk_read_stamps(host.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    st = host.reshape(MAX_BLOCKS, 8)[:n_blocks, : len(phases) + 1]
    d = np.diff(st, axis=1)
    total = st[:, -1] - st[:, 0]
    cells = "  ".join(f"{p} {d[:, i].mean():.0f} (max {d[:, i].max()})" for i, p in enumerate(phases))
    print(f"[phases] {tag}: cycles a block, mean (max) over {n_blocks} blocks: {cells}; "
          f"entry to end {total.mean():.0f} (max {total.max()})", flush=True)


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "legkilo_torch", "csrc")
    print(f"[card] {cs.card_line()}", flush=True)
    mlib, flib, elib = (build(src, tag, name, spec) for tag, name, spec in KERNELS)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    margs = cs.moments_inputs(torch, dev, np.random.default_rng(7))
    fargs, n_real = cs.fit_inputs(torch, dev)

    r, nb = margs[8].shape[0], margs[2].shape[0]
    p_i_c, body_cov_c, keys, lvl = margs[6], margs[7], margs[10], margs[11]
    with open(os.path.join(src, "insert_rows.cu")) as fh:
        sig = fh.read().split("LK_API int moments_rows_launch(")[1].split(")")[0]
    batch = [1] if "int batch" in sig else []  # a version with the fleet's replica axis
    ints = [r, nb, p_i_c.shape[0], margs[1].shape[0], *p_i_c.stride(), body_cov_c.stride(0),
            body_cov_c.stride(2), *keys.stride(), lvl.stride(0), *batch]
    mom, moms = torch.empty((r, 9), device=dev), torch.empty((r, 60), device=dev)
    mlib.moments_rows_launch.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * len(ints)
                                         + [ctypes.c_void_p])

    def stamped_moments():
        rc = mlib.moments_rows_launch(*[t.data_ptr() for t in list(margs) + [mom, moms]], *ints, stream())
        assert rc == 0, rc

    b = fargs[4].shape[0]
    fout = torch.empty((b, 35), device=dev)
    for lib in (flib, elib):
        lib.fit_slots_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def stamped_fit(lib=flib):
        rc = lib.fit_slots_launch(*[t.data_ptr() for t in list(fargs) + [fout]], b, fargs[1].shape[0],
                                  pfr._MOMS_CODE[fargs[3].dtype], stream())
        assert rc == 0, rc

    for _ in range(3):   # warm: the last launch's stamps are read
        stamped_moments()
    want = torch.cat(ir.moments_rows_call(*margs), dim=1)
    print(f"[phases] moments (R {r}, NB {nb}): stamped copy rel err "
          f"{cs.rel_err(torch.cat([mom, moms], dim=1), want):.2e} against the library's build", flush=True)
    report("moments", mlib, MOMENTS[0], (r + 31) // 32)
    for _ in range(3):
        stamped_fit()
    print(f"[phases] fit (B {b}, {n_real} map rows): stamped copy torch.equal to the library's build: "
          f"{torch.equal(fout, pfr.fit_slots_call(*fargs))}", flush=True)
    report("fit", flib, FIT[0], (b + 7) // 8)
    for _ in range(3):
        stamped_fit(elib)
    report("fit's eigen warp", elib, FIT_EIGEN[0], (b + 7) // 8)

    timed = {"moments stamped": stamped_moments, "moments": lambda: ir.moments_rows_call(*margs),
             "fit stamped": stamped_fit, "fit": lambda: pfr.fit_slots_call(*fargs)}
    ms = {k: [] for k in timed}
    for order in (list(timed), list(timed)[::-1]):
        for k in order:
            ms[k].append(cs.time_call(torch, timed[k], 200))
    for k, xs in ms.items():
        print(f"[phases] {k}: {np.mean(xs):.5f} ms a launch ({', '.join(f'{x:.5f}' for x in xs)})", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
