"""Where the one-warp chain kernel spends its cycles, on the card.

    python3 tools/chain_warp_phases.py [--kin] [DIR ...]    (default: legkilo_torch/csrc)

Each DIR holds a version of ``chain_stats.cu`` and ``lk_chain_warp.cuh`` (the
fused chain's kernel, ``chain_warp_kernel<KIN>``); ``--kin`` takes the
kinematic branch (``KIN = true``), else the IMU branch.  For each version it
builds three copies with nvcc (as is; with clock64() stamps around each call
of the bucket loop; with stamps around every __syncwarp() of the filter steps
and after each 6x6 and 9x9 inverse, downdate and the kinematic downdate),
prints ptxas's registers and spills, holds the kernel against ``chain_plain``
on chip_smoke's inputs (NB = 28, K = 1; NB = 56, K = 1; NB = 8, K = 2; a
gated-off and an empty bucket, and, kin, an event without contact), times
the versions with CUDA events in alternating order, and prints cycles a
bucket by phase.  In the kinematic update the fine stamps read, in order:
the H build, H P, S, the first 9x9 inverse (two rounds), Ai B / C Ai / the
complement, the second 9x9 inverse, the gain row, the downdate, the
retraction.  A stamp costs ~120 cycles, which the fine table includes.
Builds and SASS go to build/chain_warp_phases/ (git-ignored).  Needs one card
and nvcc; compare two versions only inside one run.
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
from legkilo_torch.ops import chain_stats

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
    src = '#include "lk_chain_warp.cuh"\nnamespace {\n' + k + "\n}\n" + LAUNCH.replace("STAMPARG", "" if mode == "plain" else "stamps,")
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


def main():
    argv = sys.argv[1:]
    use_kin = "--kin" in argv
    argv = [a for a in argv if a != "--kin"]
    dirs = argv or [os.path.join(ROOT, "legkilo_torch", "csrc")]
    tags = [os.path.basename(os.path.normpath(d)) for d in dirs]
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
        res = {}
        for tag in tags:
            got = run(tag, "plain")
            torch.cuda.synchronize()
            errs = [cs.rel_err(a, b) for a, b in zip(got, ref)]
            ok = all(e <= t for e, t in zip(errs, [1e-4, 1e-4, 1e-3, 1e-3, 0, 1e-4, 1e-4, 1e-3, 0]))
            res[tag] = []
            print(f"[phases] {branch} nb={nb} k={k} {tag}: {'OK' if ok else 'FAIL'} errs {['%.1e' % e for e in errs]}")
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


if __name__ == "__main__":
    main()
