"""The select kernel's device time by kernel name, on the card.

    python3 tools/select_profile.py [--iters N]

Builds the port's kernels (legkilo_torch/ops/_build.py), makes chip_smoke's
select inputs at the main path's shape (C = 3584 rows, L = 3 levels,
NB = 28 buckets) and at the 2 ms bucket shape (NB = 56), and for each:

- runs ``select_call`` N times under torch.profiler and prints, for every
  kernel name the card ran, its launches a call and its mean device time a
  launch;
- times ``select_call`` with CUDA events (chip_smoke.time_call);
- times, as a yardstick for the per-bucket sums only, one ``torch.bmm``
  (TF32 off) of the bucket-padded features, [NB, P, 40]^T diag(w)
  [NB, P, 40] with P = 256 (NB = 28) or 128 (NB = 56), the features and
  weights being the kernel's own output rows.

Prints the card's name and power limit first.  Needs one card and nvcc.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from legkilo_torch.ops import _build, match_geom as mg  # noqa: E402


def profile_by_name(fn, iters):
    """{kernel name: (launches, total device us)} over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        out[e.key] = (e.count, dev_us)
    return out


def bmm_yardstick(out, bidx, nb, p, iters):
    """ms of one torch.bmm of the bucket-padded x^T diag(w) x."""
    c = out.shape[1]
    b = bidx[0].long()
    keep = (b >= 0) & (b < nb)
    rows = torch.nonzero(keep)[:, 0]
    slot = torch.zeros(c, dtype=torch.long, device=out.device)
    for k in range(nb):  # each bucket's rows in order, at most P of them
        r = rows[b[rows] == k][:p]
        slot[r] = k * p + torch.arange(len(r), device=out.device)
        keep[rows[b[rows] == k][p:]] = False
    xb = torch.zeros(nb * p, 40, device=out.device)
    wb = torch.zeros(nb * p, 1, device=out.device)
    xb[slot[keep]] = out[6:46, keep].T
    wb[slot[keep], 0] = out[1, keep]
    xb, wb = xb.view(nb, p, 40), wb.view(nb, p, 1)
    xw_t = (xb * wb).transpose(1, 2).contiguous()
    return cs.time_call(torch, lambda: torch.bmm(xw_t, xb), iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_profile: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[card] {cs.card_line()}", flush=True)
    _build.build()
    rng = np.random.default_rng(7)
    kargs = cs.keys_inputs(torch, dev, rng)
    kout = mg.keys_call(*kargs, 3, 1 << 14)
    for nb, p in ((28, 256), (56, 128)):
        sargs = cs.select_inputs(torch, dev, rng, kout, nb=nb)
        call = lambda: mg.select_call(*sargs, 3, nb)  # noqa: E731
        n0 = mg.select_call.launches
        prof = profile_by_name(call, args.iters)
        calls = mg.select_call.launches - n0 - 1
        ms = cs.time_call(torch, call, args.iters)
        out = call()[0]
        bmm_ms = bmm_yardstick(out, sargs[7], nb, p, args.iters)
        print(f"[select] C = {sargs[1].shape[1]}, L = 3, NB = {nb}: select_call {ms:.5f} ms a call "
              f"(CUDA events, {args.iters} calls)", flush=True)
        for name, (count, us) in sorted(prof.items(), key=lambda kv: -kv[1][1]):
            print(f"[select]   {count / calls:.2f} launches/call  {us / count * 1e-3:.5f} ms/launch  "
                  f"{name[:100]}", flush=True)
        print(f"[select] NB = {nb}: torch.bmm of [{nb}, {p}, 40]^T diag(w) [{nb}, {p}, 40] (TF32 off): "
              f"{bmm_ms:.5f} ms", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
