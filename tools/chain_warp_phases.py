"""Where the one-warp chain kernels spend their cycles, on the card.

    python3 tools/chain_warp_phases.py [--kin] [--points] [DIR ...]
                                                (default: legkilo_torch/csrc)

Each DIR holds a version of the kernel sources.  Without ``--points`` the
tool takes the fused chain (``chain_stats.cu`` and ``lk_chain_warp.cuh``,
``chain_warp_kernel<KIN>``); ``--kin`` takes the kinematic branch
(``KIN = true``), else the IMU branch.  For each version it builds three
copies with nvcc (as is; with clock64() stamps around each call of the
bucket loop; with stamps around every __syncwarp() of the filter steps and
after each 6x6 and 9x9 inverse, downdate and the kinematic downdate),
prints ptxas's registers and spills, holds the kernel against
``chain_plain`` on chip_smoke's inputs (NB = 28, K = 1; NB = 56, K = 1;
NB = 8, K = 2; a gated-off and an empty bucket, and, kin, an event without
contact), prints whether each version's outputs are ``torch.equal`` to the
first version's, times the versions with CUDA events in alternating order,
and prints cycles a bucket by phase.  In the kinematic update the fine
stamps read, in order: the H build, H P, S, the first 9x9 inverse (two
rounds), Ai B / C Ai / the complement, the second 9x9 inverse, the gain
row, the downdate, the retraction.  A stamp costs ~120 cycles, which the
fine table includes.

With ``--points`` it takes the per-point chain (``chain_points.cu``, any
version with the entry point ``chain_points_launch``): it builds each
version as is, holds it against ``chain_points_plain`` on chip_smoke's
inputs (NB = 28, K = 1, P = 256; NB = 56, K = 1, P = 128; NB = 8, K = 2,
P = 200; an empty and a gated-off bucket), prints whether the outputs
equal the first version's, times the versions in alternating order and,
for a version whose kernel is ``chain_points_warp_kernel<KIN>`` with bulk
copies, prints cycles a bucket by phase at NB = 28: the staging of the next bucket's rows,
the event predicts, the event updates, the bucket predict, the wait for the
rows, the point phase's row loop, its butterfly and the information update.

Builds and SASS go to build/chain_warp_phases/ (git-ignored).  Needs one
card and nvcc; compare two versions only inside one run.
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
import chip_smoke as cs
from legkilo_torch.ops import chain_points, chain_stats

OUT = os.path.join(ROOT, "build", "chain_warp_phases")
os.makedirs(OUT, exist_ok=True)
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
NSTAMP = 64

LAUNCH = r'''
extern "C" int probe_launch(const float* params, const float* clocks, const float* rot0, const float* lin0,
    const float* cov0, const float* brow, const float* etime, const float* egate, const float* eacc,
    const float* egyr, const float* efp, const float* efv, const float* ect, const float* s40, float* orot,
    float* opos, float* orotcov, float* oposcov, float* onm, float* frot, float* flin, float* fcov,
    float* fclocks, long long* stamps, int nb, int kmax, int use_kin) {
  const size_t dyn = static_cast<size_t>(nb) * (3 + (use_kin ? 36 : 8) * kmax) * sizeof(float);
  if (use_kin)
    chain_warp_kernel<true><<<1, 32, dyn>>>(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
        efp, efv, ect, s40, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, STAMPARG nb, kmax);
  else
    chain_warp_kernel<false><<<1, 32, dyn>>>(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
        efp, efv, ect, s40, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks, STAMPARG nb, kmax);
  return (int)cudaGetLastError();
}
'''

PS_DEF = """
__shared__ long long ps_acc[64];
__shared__ long long ps_last;
#define PS(k) do { __syncwarp(); if (threadIdx.x == 0) { const long long n_ = clock64(); ps_acc[k] += n_ - ps_last; ps_last = n_; } __syncwarp(); } while (0)
"""


def fine_header(tag, d):
    h = open(os.path.join(d, "lk_chain_warp.cuh")).read()
    h = h.replace("namespace lk_warp {\n", "namespace lk_warp {\n" + PS_DEF, 1)
    start = h.index("// ---- the filter steps")
    head, body = h[:start], h[start:]
    out, labels, func = [], [], "?"
    for i, ln in enumerate(body.split("\n")):
        m = re.search(r"void (\w+)\(", ln)
        if m and "static" in ln:
            func = m.group(1)
        ind = ln[: len(ln) - len(ln.lstrip())]
        if ln.strip() == "__syncwarp();":
            n = len(labels)
            out.append(f"{ind}PS({n}); __syncwarp(); PS({n + 1});")
            labels += [f"{func}:{i} work", f"{func}:{i} sync"]
            continue
        out.append(ln)
        if func == "update_kin" and ln.strip() == "retract<27>(rot, lin, dx);":
            out.pop()  # the stamp goes before the retraction: the downdate ends there
            labels.append(f"{func}:{i} downdate")
            out.append(f"{ind}PS({len(labels) - 1});")
            out.append(ln)
            labels.append(f"{func}:{i} retract")
            out.append(f"{ind}PS({len(labels) - 1});")
            continue
        if re.search(r"^\s*(inv6\(|inv9\(|downdate_retract\()", ln) and ln.rstrip().endswith(";") \
                or "lin[k] += dlin[k];" in ln:
            labels.append(f"{func}:{i} {ln.strip().split('(')[0][:24]}")
            out.append(f"{ind}PS({len(labels) - 1});")
    fd = os.path.join(OUT, f"{tag}_fine")
    os.makedirs(fd, exist_ok=True)
    open(os.path.join(fd, "lk_chain_warp.cuh"), "w").write(head + "\n".join(out))
    return fd, labels


def make_source(d, mode):
    s = open(os.path.join(d, "chain_stats.cu")).read()
    a = s.index("template <bool KIN>\n__global__ void __launch_bounds__(lk_warp::NW)")
    b = s.index("\n}\n", a) + 3   # the kernel's closing brace
    pre = s[s.index("namespace {\n") + len("namespace {\n"):a]   # what the kernel uses
    k = s[a:b]
    if mode == "coarse":
        k = k.replace("float* fclocks, int nb, int kmax) {", "float* fclocks, long long* stamps, int nb, int kmax) {\n  long long acc[6] = {0, 0, 0, 0, 0, 0}; long long t_last = 0;")
        st = lambda i: f"\n    __syncwarp(); {{ long long now = clock64(); acc[{i}] += now - t_last; t_last = now; }}\n"
        k = k.replace("for (int b = 0; b < nb; ++b) {", "for (int b = 0; b < nb; ++b) {\n    __syncwarp(); t_last = clock64();", 1)
        lines = k.split("\n")
        out, n_pred, i = [], 0, 0
        while i < len(lines):
            ln = lines[i]
            out.append(ln)
            if "w::predict(" in ln:
                n_pred += 1
                out.append(st(0 if n_pred == 1 else 2))
            if "if constexpr (KIN) {" in ln and "w::update_kin(" in lines[i + 1]:
                while lines[i] != "      }":   # the end of the if/else on the branch
                    i += 1
                    out.append(lines[i])
                out.append(st(1))
            if "w::cp_wait<1>();  // bucket" in ln:
                i += 1
                out.append(lines[i])
                out.append(st(3))
            if "w::update_stats(" in ln:
                out.append(st(4))
            i += 1
        k = "\n".join(out)
        k = k.rstrip()[:-1] + "  if (lane == 0) for (int q = 0; q < 6; ++q) stamps[q] = acc[q];\n}\n"
    elif mode == "fine":
        k = k.replace("float* fclocks, int nb, int kmax) {", "float* fclocks, long long* stamps, int nb, int kmax) {")
        k = k.replace("  const float qc = lane < 30", "  if (lane == 0) { for (int q = 0; q < 64; ++q) w::ps_acc[q] = 0; w::ps_last = clock64(); }\n  __syncwarp();\n  const float qc = lane < 30", 1)
        k = k.rstrip()[:-1] + "  if (lane == 0) for (int q = 0; q < 64; ++q) stamps[q] = w::ps_acc[q];\n}\n"
    src = '#include "lk_chain_warp.cuh"\nnamespace {\n' + pre + k + "\n}\n" + LAUNCH.replace("STAMPARG", "" if mode == "plain" else "stamps,")
    return src


def build(tag, d, mode):
    inc = d
    labels = None
    if mode == "fine":
        inc, labels = fine_header(tag, d)
    path = os.path.join(OUT, f"{tag}_{mode}.cu")
    open(path, "w").write(make_source(d, mode))
    so = path[:-3] + ".so"
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-Xptxas", "-v", "-I", inc, "-I", d, "-I", os.path.join(ROOT, "legkilo_torch", "csrc"), path, "-o", so]
    return so, labels, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


TOL = [1e-4, 1e-4, 1e-3, 1e-3, 0, 1e-4, 1e-4, 1e-3, 0]   # chip_smoke's chain tolerances


def report(case, tag, got, ref, first):
    """A version's outputs against the plain version and the first version's."""
    errs = [cs.rel_err(a, b) for a, b in zip(got, ref)]
    ok = all(e <= t for e, t in zip(errs, TOL))
    same = all(torch.equal(a, b) for a, b in zip(got, first))
    print(f"[phases] {case} {tag}: {'OK' if ok else 'FAIL'} errs {['%.1e' % e for e in errs]}; "
          f"torch.equal to the first version: {same}")


def main():
    argv = sys.argv[1:]
    use_kin = "--kin" in argv
    points = "--points" in argv
    argv = [a for a in argv if a not in ("--kin", "--points")]
    dirs = argv or [os.path.join(ROOT, "legkilo_torch", "csrc")]
    tags = [os.path.basename(os.path.abspath(os.path.join(d, os.pardir, os.pardir)))
            if os.path.basename(os.path.abspath(d)) == "csrc" else os.path.basename(os.path.abspath(d))
            for d in dirs]
    tags = [t if tags.count(t) == 1 else f"{t}{i}" for i, t in enumerate(tags)]
    if points:
        return main_points(dirs, tags, use_kin)
    procs = []
    for tag, d in zip(tags, dirs):
        for mode in ("plain", "coarse", "fine"):
            procs.append((tag, mode, *build(tag, d, mode)))
    libs, fine_labels = {}, {}
    for tag, mode, so, labels, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            print(f"[phases] build {tag} {mode} FAILED\n{text}")
            sys.exit(1)
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln:
                print(f"[phases] {tag} {mode}: {ln.strip()}")
        lib = ctypes.CDLL(so)
        lib.probe_launch.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 3
        libs[(tag, mode)] = lib
        if labels:
            fine_labels[tag] = labels
        if mode == "plain":
            with open(os.path.join(OUT, f"sass_{tag}.txt"), "w") as fh:
                subprocess.run([os.path.join(os.path.dirname(NVCC), "cuobjdump"), "-sass", so], stdout=fh, stderr=subprocess.STDOUT)
    dev = torch.device("cuda")
    branch = "kin" if use_kin else "imu"
    for nb, k in ((28, 1), (56, 1), (8, 2)):
        args = cs.chain_holes(cs.chain_inputs(torch, dev, np.random.default_rng(7), use_kin, nb, k))
        ref = chain_stats.chain_plain(*args, use_kin=use_kin)
        inp = list(args)
        stamps = torch.zeros(NSTAMP, dtype=torch.int64, device=dev)

        def run(tag, mode):
            outs = chain_stats.empty_chain_outputs(nb, dev)
            rc = libs[(tag, mode)].probe_launch(*[t.data_ptr() for t in inp + list(outs)], stamps.data_ptr(), nb, k,
                                                int(use_kin))
            assert rc == 0, rc
            return outs
        res, outs = {}, {}
        for tag in tags:
            outs[tag] = got = run(tag, "plain")
            torch.cuda.synchronize()
            report(f"{branch} nb={nb} k={k}", tag, got, ref, outs[tags[0]])
            res[tag] = []
        order = tags + tags[::-1] + tags + tags[::-1]
        for tag in order:
            res[tag].append(cs.time_call(torch, lambda: run(tag, "plain"), 100))
        for tag in tags:
            print(f"[phases] {branch} nb={nb} k={k} {tag}: ms {' '.join('%.4f' % x for x in res[tag])}")
        if nb == 28:
            for tag in tags:
                stamps.zero_()
                run(tag, "coarse")
                torch.cuda.synchronize()
                st = stamps.cpu().numpy()[:5] / nb
                names = ["ev_predict", f"{branch}_update", "bkt_predict", "s40_wait", "stats_update"]
                print(f"[phases] {tag} cycles/bucket: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, st)) + f", sum {st.sum():.0f}")
            for tag in tags:
                stamps.zero_()
                run(tag, "fine")
                torch.cuda.synchronize()
                st = stamps.cpu().numpy() / nb
                labels = fine_labels[tag]
                print(f"[phases] {tag} fine stamps, cycles/bucket (sum {st[:len(labels)].sum():.0f}):")
                for lab, v in zip(labels, st):
                    print(f"[phases]   {v:8.0f}  {lab}")
    print("[phases]", cs.card_line())


LAUNCH_POINTS = r'''
extern "C" int probe_launch(const float* params, const float* clocks, const float* rot0, const float* lin0,
    const float* cov0, const float* btime, const float* bgate, const float* etime, const float* egate,
    const float* eacc, const float* egyr, const float* efp, const float* efv, const float* ect, const float* pi,
    const float* n, const float* nd, const float* r, const float* m, float* orot, float* opos, float* orotcov,
    float* oposcov, float* onm, float* frot, float* flin, float* fcov, float* fclocks, long long* stamps,
    int nb, int kmax, int P, int use_kin) {
  const size_t dyn = (static_cast<size_t>(2) * 9 * P + static_cast<size_t>(nb) * (2 + (use_kin ? 36 : 8) * kmax)) * 4;
  auto al = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int bulk = P > 0 && P % 4 == 0 && al(pi) && al(n) && al(nd) && al(r) && al(m);
  if (use_kin) {
    cudaFuncSetAttribute(chain_points_warp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    chain_points_warp_kernel<true><<<1, 32, dyn>>>(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate,
        eacc, egyr, efp, efv, ect, pi, n, nd, r, m, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks,
        stamps, nb, kmax, P, bulk);
  } else {
    cudaFuncSetAttribute(chain_points_warp_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    chain_points_warp_kernel<false><<<1, 32, dyn>>>(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate,
        eacc, egyr, efp, efv, ect, pi, n, nd, r, m, orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks,
        stamps, nb, kmax, P, bulk);
  }
  return (int)cudaGetLastError();
}
'''
POINT_PHASES = ["stage_next", "ev_predict", "ev_update", "bkt_predict", "rows_wait", "point_rows",
                "butterfly", "info_update"]


def points_stamped_source(d):
    """chain_points.cu's warp kernel with clock64() stamps after each phase
    of the bucket loop (POINT_PHASES), summed on lane 0 into stamps[0:8]."""
    s = open(os.path.join(d, "chain_points.cu")).read()
    a = s.index("template <bool KIN>\n__global__ void __launch_bounds__(lk_warp::NW)\nchain_points_warp_kernel(")
    b = s.index("\n}\n", a) + 3
    k = s[a:b].replace("float* fclocks, int nb, int kmax, int P, int bulk) {",
                       "float* fclocks, long long* stamps, int nb, int kmax, int P, int bulk) {\n"
                       "  long long ps_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; long long t_last = 0;")
    k = k.replace("for (int b = 0; b < nb; ++b) {", "for (int b = 0; b < nb; ++b) {\n    __syncwarp(); t_last = clock64();", 1)
    st = lambda i: f"    __syncwarp(); {{ long long now = clock64(); ps_acc[{i}] += now - t_last; t_last = now; }}"
    lines, out, n_pred, i = k.split("\n"), [], 0, 0
    while i < len(lines):
        ln = lines[i]
        out.append(ln)
        if "w::cp_commit();  // possibly empty" in ln:
            out.append(st(0))
        if "w::predict(" in ln:
            n_pred += 1
            out.append(st(1 if n_pred == 1 else 3))
        if "if constexpr (KIN) {" in ln and "w::update_kin(" in lines[i + 1]:
            while lines[i] != "      }":
                i += 1
                out.append(lines[i])
            out.append(st(2))
        if "// Bucket b's point rows" in ln:
            while lines[i] != "    __syncwarp();":
                i += 1
                out.append(lines[i])
            out.append(st(4))
        if "w::point_rows(" in ln:
            out.append(st(5))
        if "w::butterfly(" in ln:
            out.append(st(6))
        if "if (nm > 0.5f) {" in ln:
            while lines[i] != "    }":
                i += 1
                out.append(lines[i])
            out.append(st(7))
        i += 1
    k = "\n".join(out)
    k = k.rstrip()[:-1] + "  if (lane == 0) for (int q = 0; q < 8; ++q) stamps[q] = ps_acc[q];\n}\n"
    return '#include "lk_chain_warp.cuh"\nnamespace {\nconstexpr int ROW_FLOATS = 9;\n' + k + "}\n" + LAUNCH_POINTS


def build_points(tag, d, stamped):
    src = os.path.join(d, "chain_points.cu")
    if stamped:
        src = os.path.join(OUT, f"points_{tag}_stamped.cu")
        open(src, "w").write(points_stamped_source(d))
    so = os.path.join(OUT, f"points_{tag}_{'stamped' if stamped else 'plain'}.so")
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-Xptxas", "-v", "-I", d, src, "-o", so]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main_points(dirs, tags, use_kin):
    """The per-point chain: each version against chain_points_plain, its
    bits against the first version's, times in turns, warp phases."""
    procs, batched = [], {}
    for tag, d in zip(tags, dirs):
        text = open(os.path.join(d, "chain_points.cu")).read()
        warp = "int P, int bulk) {" in text   # stampable
        batched[tag] = "int use_kin, int batch, void* stream" in text   # the launcher takes a replica count

        for stamped in (False, True) if warp else (False,):
            procs.append((tag, stamped, *build_points(tag, d, stamped)))
    libs = {}
    for tag, stamped, so, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            print(f"[phases] build points {tag} {'stamped' if stamped else 'plain'} FAILED\n{text}")
            sys.exit(1)
        for ln in text.splitlines():
            if "Used" in ln or "spill" in ln:
                print(f"[phases] points {tag} {'stamped' if stamped else 'plain'}: {ln.strip()}")
        lib = ctypes.CDLL(so)
        if stamped:
            lib.probe_launch.argtypes = [ctypes.c_void_p] * 29 + [ctypes.c_int] * 4
        else:
            lib.chain_points_launch.argtypes = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * (4 + batched[tag])
                                                + [ctypes.c_void_p])
            with open(os.path.join(OUT, f"sass_points_{tag}.txt"), "w") as fh:
                subprocess.run([os.path.join(os.path.dirname(NVCC), "cuobjdump"), "-sass", so], stdout=fh,
                               stderr=subprocess.STDOUT)
        libs[(tag, stamped)] = lib
    dev = torch.device("cuda")
    branch = "points_kin" if use_kin else "points_imu"
    for nb, k, p in ((28, 1, 256), (56, 1, 128), (8, 2, 200)):
        args = cs.chain_points_inputs(torch, dev, np.random.default_rng(7), use_kin, nb, k, p)
        ref = chain_points.chain_points_plain(*args, use_kin=use_kin)
        ptrs = [t.data_ptr() for t in args]
        stamps = torch.zeros(8, dtype=torch.int64, device=dev)

        def run(tag, stamped=False):
            outs = chain_stats.empty_chain_outputs(nb, dev)
            optrs = [t.data_ptr() for t in outs]
            if stamped:
                rc = libs[(tag, True)].probe_launch(*ptrs, *optrs, stamps.data_ptr(), nb, k, p, int(use_kin))
            else:
                rc = libs[(tag, False)].chain_points_launch(*ptrs, *optrs, nb, k, p, int(use_kin),
                                                             *([1] if batched[tag] else []), None)
            assert rc == 0, rc
            return outs
        res, outs = {}, {}
        for tag in tags:
            outs[tag] = got = run(tag)
            torch.cuda.synchronize()
            report(f"{branch} nb={nb} k={k} p={p}", tag, got, ref, outs[tags[0]])
            res[tag] = []
        for tag in tags + tags[::-1] + tags + tags[::-1]:
            res[tag].append(cs.time_call(torch, lambda: run(tag), 100))
        for tag in tags:
            print(f"[phases] {branch} nb={nb} k={k} p={p} {tag}: ms {' '.join('%.4f' % x for x in res[tag])}")
        if nb == 28:
            for tag in tags:
                if (tag, True) not in libs:
                    continue
                stamps.zero_()
                run(tag, stamped=True)
                torch.cuda.synchronize()
                st = stamps.cpu().numpy() / nb
                print(f"[phases] {tag} {branch} cycles/bucket: "
                      + ", ".join(f"{n} {v:.0f}" for n, v in zip(POINT_PHASES, st)) + f", sum {st.sum():.0f}")
    print("[phases]", cs.card_line())


if __name__ == "__main__":
    main()
