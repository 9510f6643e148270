"""Time this checkout's kernels against another build of them, on one
card, in one process.

    python -m amg_tpu_torch.utils.kernel_ab --other DIR [DIR ...] \
        [--sides 1023 4095 8191] [--reps 20] [--nine] [--random-planes]

Each DIR is the root of another checkout of the repository (for example an
earlier commit unpacked with ``git archive``, or a copy whose
``amg_tpu_torch/csrc`` holds a variant of a kernel). Its ``csrc/*.cu`` are
compiled with this checkout's nvcc flags into ``build/amg_tpu_torch/ab/``;
both libraries' C entry points are then called directly (pointers, weights
and the stream prepared once, so the host cost is the ctypes call), on the
same random packed fields at each side's M = (side + 1) / 2, for K1
(amg_packed_sweep), K2 (amg_down_leg), K3 (amg_up_leg), K8
(amg_residual_restrict), K9 (amg_packed_sweep_rm) and K4 (the df32
residual + rss on packed df32 fields, always the Poisson weights: they must
be powers of two), and on random unpacked (side, side) fields for K5
(amg_rbgs_sweep_const, the Poisson weights) and K6 (amg_rbgs_sweep_var, on
varcoef.jump_planes, or with ``--random-planes`` on random positive
planes); every sweep symmetric with omega 1. Each pair is checked bitwise
equal (K4: r.hi bitwise, the rss within 1e-5 relative), then timed with
CUDA events over ``reps`` back-to-back launches in turns other, this,
this, other (each build's better of two).
K4 is called by the signature its build exports: ``amg_df_residual_rss``
(one launch writes r.hi and the f64 rss), or a build before it,
``amg_df_residual`` (f32 per-block partials), followed by the f64 sum its
wrapper launched (``partials.to(float64).sum()``), which is timed with it.
The packed kernels' weights are the 5-point Poisson ones at the side, or
with ``--nine`` a 9-point set (the zero pattern of the Galerkin levels).
Prints one line per kernel and size and, last, one JSON object with the
times and the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from amg_tpu_torch.models import varcoef
from amg_tpu_torch.ops.kernels import _build
from amg_tpu_torch.ops.rap import poisson_const_w33
from amg_tpu_torch.sparse.packed import pack

# C entry point -> kernel
ENTRIES = {"amg_packed_sweep": "K1", "amg_down_leg": "K2",
           "amg_up_leg": "K3", "amg_residual_restrict": "K8",
           "amg_packed_sweep_rm": "K9", "amg_rbgs_sweep_const": "K5",
           "amg_rbgs_sweep_var": "K6", "amg_df_residual_rss": "K4"}
# K4's entry points in builds before amg_df_residual_rss
_P, _I = _build._P, _build._I
OLD_DF = {"amg_df_residual": (_P, _P, _P, _P, _P, _P, _I, _build._W9, _P),
          "amg_df_partials_count": (_I,)}


def build_other(root: Path) -> ctypes.CDLL:
    """Compile ``root``'s kernel sources with this checkout's flags."""
    csrc = root / "amg_tpu_torch" / "csrc"
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no kernel sources under {csrc}")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.read_bytes())
    out = _build.BUILD_DIR / "ab" / f"lib_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.compile_library(srcs, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in {**_build._SIGNATURES, **OLD_DF}.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def df_launch(lib, side: int, dev, rng):
    """K4's (launch, (r_hi, rss), inputs) by ``lib``'s own signature."""
    m = (side - 1) // 2
    M = m + 1

    def field(scale=1.0):
        x = torch.as_tensor(rng.standard_normal((side, side)) * scale,
                            dtype=torch.float32, device=dev)
        return pack(x, m)
    bh, bl, uh, ul = field(), field(1e-8), field(), field(1e-8)
    w9 = _build.weights(poisson_const_w33(side, 1)[0])
    s = _build.stream_of(bh)
    p = torch.Tensor.data_ptr
    r_hi = torch.empty_like(bh)
    if hasattr(lib, "amg_df_residual_rss"):
        parts = torch.empty(lib.amg_df_block_count(M), dtype=torch.float64,
                            device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        rss = torch.empty((), dtype=torch.float64, device=dev)
        a = (p(bh), p(bl), p(uh), p(ul), p(r_hi), p(parts), p(counter),
             p(rss), M, w9, s)

        def launch():
            _build.check(lib.amg_df_residual_rss(*a), "amg_df_residual_rss")
        held = (counter, parts)
    else:
        parts = torch.empty(lib.amg_df_partials_count(M),
                            dtype=torch.float32, device=dev)
        rss = torch.empty(1, dtype=torch.float64, device=dev)
        a = (p(bh), p(bl), p(uh), p(ul), p(r_hi), p(parts), M, w9, s)

        def launch():
            _build.check(lib.amg_df_residual(*a), "amg_df_residual")
            torch.sum(parts.to(torch.float64), 0, keepdim=True, out=rss)
        held = (parts,)
    return launch, (r_hi, rss), (bh, bl, uh, ul, *held)


def same_outputs(name: str, ref, outs) -> bool:
    """Bitwise equal outputs; K4's rss (summed in another order by
    another design) within 1e-5 relative."""
    if name == "amg_df_residual_rss":
        a, b = float(ref[1].reshape(())), float(outs[1].reshape(()))
        return torch.equal(ref[0], outs[0]) and abs(a - b) <= 1e-5 * abs(a)
    return all(torch.equal(r, o) for r, o in zip(ref, outs))


NINE_POINT = ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0), (-0.5, -1.0, -0.5))


def calls(lib, side: int, dev, nine: bool = False,
          random_planes: bool = False) -> dict:
    """{entry: (launch, outputs, inputs)} on fresh fields at ``side``
    (the same values for every library); the inputs are held so that the
    pointers in the launches stay valid."""
    m = (side - 1) // 2
    M = m + 1
    rng = np.random.default_rng(side)

    def field():
        x = torch.as_tensor(rng.standard_normal((side, side)),
                            dtype=torch.float32, device=dev)
        return pack(x, m)
    u4, b4 = field(), field()
    u_rm = u4.permute(1, 0, 2).reshape(M, 4 * M).contiguous()
    b_rm = b4.permute(1, 0, 2).reshape(M, 4 * M).contiguous()
    uc = torch.nn.functional.pad(u4[0, :m, :m], (0, 1, 0, 1))
    w33 = NINE_POINT if nine else poisson_const_w33(side, 1)[0]
    w9, inv, om = _build.weights(w33), 1.0 / w33[1][1], 1.0
    s = _build.stream_of(u4)
    p = torch.Tensor.data_ptr
    o_u, o_bc, o_rm = (torch.empty_like(u4), torch.empty((M, M), device=dev),
                       torch.empty_like(u_rm))
    u2, b2 = (torch.as_tensor(rng.standard_normal((side, side)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    if random_planes:
        c = torch.as_tensor(rng.random((3, 3, side, side)) + 0.5,
                            dtype=torch.float32, device=dev)
        c[1, 1] += 8.0
    else:
        c = varcoef.jump_planes(side, device=dev)
    o_2 = torch.empty_like(u2)
    w5 = poisson_const_w33(side, 1)[0]
    args = {
        "amg_packed_sweep": ((p(u4), p(b4), p(o_u), M, w9, inv, om, 1, s),
                             (o_u,)),
        "amg_down_leg": ((p(u4), p(b4), p(o_u), p(o_bc), M, w9, inv, om, 1,
                          s), (o_u, o_bc)),
        "amg_up_leg": ((p(u4), p(b4), p(uc), p(o_u), M, w9, inv, om, 1, s),
                       (o_u,)),
        "amg_residual_restrict": ((p(u4), p(b4), p(o_bc), M, w9, s),
                                  (o_bc,)),
        "amg_packed_sweep_rm": ((p(u_rm), p(b_rm), p(o_rm), M, w9, inv, om,
                                 1, s), (o_rm,)),
        "amg_rbgs_sweep_const": ((p(u2), p(b2), p(o_2), side,
                                  _build.weights(w5), 1.0 / w5[1][1], om, 1,
                                  s), (o_2,)),
        "amg_rbgs_sweep_var": ((p(u2), p(b2), p(c), p(o_2), side, om, 1, s),
                               (o_2,)),
    }
    out = {}
    for name, (a, outs) in args.items():
        fn = getattr(lib, name)

        def launch(fn=fn, a=a, name=name):
            _build.check(fn(*a), name)
        out[name] = (launch, outs, (u4, b4, uc, u_rm, b_rm, u2, b2, c))
    out["amg_df_residual_rss"] = df_launch(lib, side, dev, rng)
    return out


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="+", required=True, type=Path)
    ap.add_argument("--sides", nargs="+", type=int,
                    default=[1023, 4095, 8191])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--nine", action="store_true",
                    help="9-point weights in place of 5-point Poisson")
    ap.add_argument("--random-planes", action="store_true",
                    help="K6 on random positive planes, not the jump ones")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    this = _build.library()
    others = {str(d): build_other(d) for d in args.other}
    rows = []
    for side in args.sides:
        M = (side + 1) // 2
        mine = calls(this, side, dev, args.nine, args.random_planes)
        for d, lib in others.items():
            theirs = calls(lib, side, dev, args.nine, args.random_planes)
            for name, kernel in ENTRIES.items():
                fa, outs_a, _ = theirs[name]
                fb, outs_b, _ = mine[name]
                fa()
                ref = [o.clone() for o in outs_a]
                fb()
                same = same_outputs(name, ref, outs_b)
                a1 = time_ms(fa, args.reps)
                b1 = time_ms(fb, args.reps)
                b2 = time_ms(fb, args.reps)
                a2 = time_ms(fa, args.reps)
                ta, tb = min(a1, a2), min(b1, b2)
                size = f"n={side}" if "rbgs" in name else f"M={M}"
                print(f"{kernel} {name} {size} other={d}: other {ta:.4f} ms, "
                      f"this {tb:.4f} ms (this/other {tb / ta:.3f}; runs "
                      f"{a1:.4f} {b1:.4f} {b2:.4f} {a2:.4f}), bitwise "
                      f"equal {same}", flush=True)
                rows.append({"kernel": kernel, "entry": name, "M": M,
                             "side": side,
                             "weights": "nine" if args.nine else "five",
                             "planes": "random" if args.random_planes
                             else "jump",
                             "other": d, "other_ms": ta, "this_ms": tb,
                             "bitwise_equal": same})
            del theirs
        del mine
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
