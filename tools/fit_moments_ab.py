"""The moments and refit kernels before and after their indexed redesign, on one card, in turns.

    python3 tools/fit_moments_ab.py OLD_DIR [NEW_DIR]   (NEW_DIR default: legkilo_torch/csrc)

OLD_DIR holds the version of ``insert_rows.cu`` and ``plane_fit_rows.cu``
(and the headers they include) that takes the JAX row layout
(``moments_launch`` / ``fit_rows_launch``): give a parent's
``legkilo_torch/csrc`` unpacked under ``build/``.  NEW_DIR holds the version
that reads its rows by index (``moments_rows_launch`` / ``fit_slots_launch``).
The tool builds one library of the two sources for each with nvcc (the flags
of ops/_build.py) and prints ptxas's registers, spills and stack frame for
their kernels.

Inputs are chip_smoke's: the moments rows as the insert phase hands them
over (R 4,096, NB 28, 3,584 points; ``chip_smoke.moments_inputs``) and the
refit rows of a short run's map (B 1,024; ``chip_smoke.fit_inputs``).  For
each kernel it times, with CUDA events (chip_smoke.time_call, old then
new, then new then old; 200 calls a turn, 40 for a step, so that the old
step's host work stays inside the spin in front of them):

* the kernel alone: the old kernel on its JAX-layout rows, built once, and
  the new kernel on the indexed inputs, outputs allocated once;
* the whole replaced step: the old glue (the gathers, concatenations,
  transposes and per-call ``par`` / sizes builds the call sites ran before
  the redesign, as written there) plus the old kernel, against the new
  single launch with its output allocation;

beside the library's empty kernel (the launch floor), and the host's
microseconds a step (the wall clock over 200 steps, then a synchronize).
It checks the new fit's outputs ``torch.equal`` to the old kernel's and
both moments versions at rel 1e-4 a moment row of ``moments_rows_plain``,
and says whether the two moments versions are ``torch.equal``.
Builds go to build/fit_moments_ab/ (git-ignored).  Needs one card and nvcc.
"""
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from legkilo_torch.ops import _build  # noqa: E402
from legkilo_torch.ops import insert_rows as ir  # noqa: E402
from legkilo_torch.ops import plane_fit_rows as pfr  # noqa: E402

OUT = os.path.join(ROOT, "build", "fit_moments_ab")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
F32 = torch.float32
P, I = ctypes.c_void_p, ctypes.c_int
ITERS = 200
# The old step enqueues ~300 us of host work a call: 40 of them stay inside
# the ~20 ms spin time_call puts in front, so its events time the device.
STEP_ITERS = 40


def moments_batch_args(d):
    """[1] where this version's moments_rows_launch takes the fleet's
    replica count (``int batch``: a version with the replica axis), else []."""
    with open(os.path.join(d, "insert_rows.cu")) as fh:
        src = fh.read()
    sig = src[src.index("LK_API int moments_rows_launch("):]
    return [1] if "int batch" in sig[: sig.index(")")] else []


def build(tag, d):
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{tag}.so")
    cmd = [NVCC] + _build.NVCC_FLAGS + ["-shared", "-Xptxas", "-v", "-I", d,
                                        os.path.join(d, "insert_rows.cu"), os.path.join(d, "plane_fit_rows.cu"), "-o", so]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode:
        raise RuntimeError(f"build {tag} failed:\n{out.stdout}")
    name = "?"
    for ln in out.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif "Used" in ln or "spill" in ln:
            print(f"[ab] {tag} {name[:60]}: {ln.strip()}", flush=True)
    return ctypes.CDLL(so)


def ptrs(*ts):
    return [t.data_ptr() for t in ts]


def stream():
    return torch.cuda.current_stream().cuda_stream


def check(rc):
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}")


def old_moments(lib, margs):
    """insert_phase as it ran before the indexed kernel: its glue, then the
    JAX-layout kernel.  Returns (step, kernel alone, rows)."""
    lib.moments_launch.argtypes = [P] * 6 + [I, P]
    ext_r, _, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c, pidx, bidx, keys, lvl = margs
    nb, r, dev = rots.shape[0], pidx.shape[0], rots.device

    def glue():
        bidx_r = torch.clamp(bidx, max=nb - 1)[pidx]
        sizes = torch.tensor([0.5 / (2.0 ** l) for l in range(3)], dtype=F32, device=dev)
        par = torch.cat([ext_r.reshape(9), torch.zeros(ir.PAR_W - 9, dtype=F32, device=dev)])
        bucket_rows = torch.cat([rots.reshape(nb, 9), poss, rot_covs.reshape(nb, 9), pos_covs.reshape(nb, 9)], 1)
        brow_t = bucket_rows[bidx_r].T.contiguous()
        prow_t = torch.cat([p_i_c, body_cov_c.reshape(-1, 9)], dim=1)[pidx].T.contiguous()
        return par, prow_t, brow_t, keys.T.to(F32).contiguous(), sizes[lvl][None, :]

    def launch(args, out):
        check(lib.moments_launch(*ptrs(*args, out), r, stream()))
        return out

    def step():
        out = launch(glue(), torch.empty((69, r), dtype=F32, device=dev))
        return out[0:9].T, out[9:69].T

    args, out = glue(), torch.empty((69, r), dtype=F32, device=dev)
    return step, lambda: launch(args, out), step


def new_moments(lib, margs, batch=()):
    """The indexed kernel, launched as moments_rows_call launches it
    (``batch``: [1] where the version takes the fleet's replica count)."""
    lib.moments_rows_launch.argtypes = [P] * 14 + [I] * (11 + len(batch)) + [P]
    r, nb, dev = margs[8].shape[0], margs[2].shape[0], margs[2].device
    p_i_c, body_cov_c, keys, lvl = margs[6], margs[7], margs[10], margs[11]
    ints = [r, nb, p_i_c.shape[0], margs[1].shape[0], *p_i_c.stride(), body_cov_c.stride(0),
            body_cov_c.stride(2), *keys.stride(), lvl.stride(0), *batch]

    def launch(mom, moms):
        check(lib.moments_rows_launch(*ptrs(*margs, mom, moms), *ints, stream()))
        return mom, moms

    def step():
        return launch(torch.empty((r, 9), dtype=F32, device=dev), torch.empty((r, 60), dtype=F32, device=dev))

    outs = (torch.empty((r, 9), dtype=F32, device=dev), torch.empty((r, 60), dtype=F32, device=dev))
    return step, lambda: launch(*outs), step


def old_fit(lib, fargs):
    """The refit as _insert_finish ran it before the indexed kernel: its
    glue, then the JAX-layout kernel.  Rows come out [B, 35] for the
    comparison."""
    lib.fit_rows_launch.argtypes = [P] * 4 + [I, P]
    par0, meta_x, mom_x, moms_x, fs = fargs
    b, dev, thr = fs.shape[0], fs.device, float(par0[0])

    def glue():
        meta_r = meta_x[fs]
        mom_r = torch.cat([mom_x[fs], moms_x[fs].to(F32)], dim=-1)
        par = torch.zeros(8, dtype=F32, device=dev)
        par[0] = thr
        return par, mom_r.T.contiguous(), meta_r.T.contiguous()

    def launch(args, out):
        check(lib.fit_rows_launch(*ptrs(*args, out), b, stream()))
        return out

    def step():
        out = launch(glue(), torch.empty((35, b), dtype=F32, device=dev))
        return out[0:31].T, out[31:35].T

    args, out = glue(), torch.empty((35, b), dtype=F32, device=dev)
    return step, lambda: launch(args, out), lambda: launch(glue(), torch.empty((35, b), device=dev)).T


def new_fit(lib, fargs):
    """The indexed kernel, launched as fit_slots_call launches it."""
    lib.fit_slots_launch.argtypes = [P] * 6 + [I] * 3 + [P]
    b, dev = fargs[4].shape[0], fargs[4].device
    code = pfr._MOMS_CODE[fargs[3].dtype]

    def launch(out):
        check(lib.fit_slots_launch(*ptrs(*fargs, out), b, fargs[1].shape[0], code, stream()))
        return out

    def step():
        out = launch(torch.empty((b, 35), dtype=F32, device=dev))
        return out[:, 0:31], out[:, 31:35]

    out = torch.empty((b, 35), dtype=F32, device=dev)
    return step, lambda: launch(out), lambda: launch(torch.empty((b, 35), dtype=F32, device=dev))


def host_us(fn):
    """Host microseconds a call: the wall clock over ITERS calls, then a
    synchronize (the enqueue cost, which the host-bound path pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS * 1e6


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    old_dir = sys.argv[1]
    new_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(ROOT, "legkilo_torch", "csrc")
    print(f"[card] {cs.card_line()}", flush=True)
    libs = {"old": build("old", old_dir), "new": build("new", new_dir)}
    dev = torch.device("cuda")
    margs = cs.moments_inputs(torch, dev, np.random.default_rng(7))
    fargs, n_real = cs.fit_inputs(torch, dev)
    cases = {
        "moments": {"old": old_moments(libs["old"], margs),
                    "new": new_moments(libs["new"], margs, moments_batch_args(new_dir))},
        "fit": {"old": old_fit(libs["old"], fargs), "new": new_fit(libs["new"], fargs)},
    }

    ok = True
    ref = torch.cat(ir.moments_rows_plain(*margs), dim=1)
    rows = {}
    for tag in ("old", "new"):
        rows[tag] = got = torch.cat([x.contiguous() for x in cases["moments"][tag][2]()], dim=1)
        torch.cuda.synchronize()
        e = max(cs.rel_err(got[:, i], ref[:, i]) for i in range(69))
        print(f"[ab] moments {tag}: rel err {e:.2e} a moment row against moments_rows_plain", flush=True)
        ok = ok and e <= 1e-4
    print(f"[ab] moments: new torch.equal to old: {torch.equal(rows['old'], rows['new'])}; differing "
          f"rows {int((rows['old'] != rows['new']).any(dim=1).sum())}", flush=True)
    old_rows, new_rows = cases["fit"]["old"][2](), cases["fit"]["new"][2]()
    torch.cuda.synchronize()
    same = torch.equal(old_rows, new_rows)
    print(f"[ab] fit: {n_real} map rows + {fargs[4].shape[0] - n_real} sentinel rows; new torch.equal "
          f"to old: {same}; differing slots {int((old_rows != new_rows).any(dim=1).sum())}", flush=True)
    ok = ok and same
    if not ok:
        return 1

    empty = _build._function("lk_empty_launch", 0, 0)
    floor = lambda: empty(stream())  # noqa: E731
    ms = {}
    for order in (("old", "new"), ("new", "old")):
        for name, vs in cases.items():
            for what, k, iters in (("kernel", 1, ITERS), ("step", 0, STEP_ITERS)):
                ms.setdefault((name, what, "floor"), []).append(cs.time_call(torch, floor, iters))
                for tag in order:
                    ms.setdefault((name, what, tag), []).append(cs.time_call(torch, vs[tag][k], iters))
    for (name, what, tag), xs in ms.items():
        if tag == "floor":
            continue
        print(f"[ab] {name} {what} {tag}: {np.mean(xs):.5f} ms ({', '.join(f'{x:.5f}' for x in xs)}), "
              f"floor {np.mean(ms[(name, what, 'floor')]):.5f}", flush=True)
    for name, vs in cases.items():
        for tag in ("old", "new", "old", "new"):
            print(f"[ab] {name} step {tag}: host {host_us(vs[tag][0]):.1f} us a step", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
