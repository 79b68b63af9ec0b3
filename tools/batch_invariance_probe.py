"""Whether a PyTorch product rounds the same for a replica at any batch count.

    python3 tools/batch_invariance_probe.py [--device cuda|cpu]

The fleet (core/filter_fleet.py) runs the single step's ops on [B, ...]
tensors.  A replica of the fleet equals its single run bit for bit only
where each op gives a matrix the same bits whatever B is.  For the shapes
of the ESKF and of the match glue, this prints for each product (and a
few other ops) whether, on seeded random inputs, the result at B = 4
equals four results at B = 1 (``B4==B1``), four unbatched results
(``B4==2D``), and whether B = 1 equals the unbatched one (``B1==2D``).
TF32 is off, as the port runs.  With ``--device cuda`` it prints the
card's name and power limit first; it needs no built kernel.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B = 4
MATMULS = [((3, 3), (3, 3)), ((6, 6), (6, 6)), ((9, 9), (9, 9)), ((30, 30), (30, 30)),
           ((30, 6), (6, 6)), ((30, 18), (18, 18)), ((18, 30), (30, 18)), ((40, 40), (40, 7)),
           ((7, 40), (40, 7)), ((30, 18), (18, 30)), ((384, 3), (3, 3)), ((10752, 3), (3, 3)),
           ((30, 3), (3, 3))]


def check(tag, fn, shapes, dev):
    xs = [torch.randn((B,) + s, device=dev) for s in shapes]
    full = fn(*xs)
    ones = torch.cat([fn(*[x[i:i + 1] for x in xs]) for i in range(B)])
    unbatched = torch.stack([fn(*[x[i] for x in xs]) for i in range(B)])
    print(f"{tag:36s} B4==B1 {torch.equal(full, ones)!s:5s}  B4==2D {torch.equal(full, unbatched)!s:5s}"
          f"  B1==2D {torch.equal(ones, unbatched)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    import legkilo_torch  # noqa: F401  (TF32 off)

    if dev.type == "cuda":
        import chip_smoke

        print(f"[card] {chip_smoke.card_line()}")
    torch.manual_seed(0)
    for sa, sb in MATMULS:
        check(f"{sa} @ {sb}", lambda a, b: a @ b, [sa, sb], dev)
    check("(30,18) @ (18,) as a product", lambda k, z: (k @ z[..., None])[..., 0], [(30, 18), (18,)], dev)
    check("(30,18) * (18,) summed", lambda k, z: (k * z[..., None, :]).sum(-1), [(30, 18), (18,)], dev)
    check("einsum ij,njk,lk (128 rows)", lambda a, b: torch.einsum("...ij,...njk,...lk->...nil", a, b, a),
          [(3, 3), (128, 3, 3)], dev)
    check("(3,3) broadcast @ (40,3,3)", lambda a, b: a[..., None, :, :] @ b, [(3, 3), (40, 3, 3)], dev)
    check("sum over the last axis (30,30)", lambda a: a.sum(-1), [(30, 30)], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
