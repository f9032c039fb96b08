"""Times the per-pixel winner kernel's block counts on one CUDA card.

    python tools/winner_tiles.py [--blocks 1 33 66 132 198 264] [--parent DIR] [--reps 100]

Cases: chip_smoke.py's timed winner shapes (the fusion key at the diag's
shapes, the projective ScanNet gated buffer, the golden shape, the
``pallas_rmw`` contract at the diag's shapes, 480x640 with N = 2*P) and the
main path's own inputs (the last fusion step of a run of each of the four
paths). For each, checks ``csrc/winner.cu`` bit for bit against the plain
version and prints its device time (calls queued behind a sleep) for each
block count, the card's most and ``winner_kernel.grid``'s choice included,
and the host time a call takes to return while the card is busy.

``--parent DIR`` also loads the ``gradslam_tpu_torch`` package of another
checkout (under another name) and times its ``pixel_winner`` on the same
inputs, checked the same way, in turns: parent, this kernel, this kernel,
parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_package(tree: pathlib.Path, name: str):
    """Imports ``tree/gradslam_tpu_torch`` as the package ``name``."""
    pkg = tree / "gradslam_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _host_us(fn, reps: int, batches: int = 5) -> float:
    """Host microseconds a call takes to return, the card kept busy by a
    sleep so that no call waits for it: the median of ``batches`` batches
    of ``reps`` calls (the host's clock spreads more than the card's)."""
    import chip_smoke

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        torch.cuda._sleep(chip_smoke.SLEEP_CYCLES_PER_S // 4)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 33, 66, 132, 198, 264])
    ap.add_argument("--parent", help="a checkout whose pixel_winner to time beside this one")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("winner_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from gradslam_tpu_torch.ops.winner import pixel_winner, pixel_winner_reference, winner_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    winner_kernel.load()
    most = winner_kernel.max_blocks()
    parent = None
    if args.parent:
        parent = _load_package(pathlib.Path(args.parent).resolve(), "parent_gradslam_tpu_torch").ops.winner
        parent.winner_kernel.load()

    gen = np.random.default_rng(0)
    cases = {}
    for name, B, N, P, CAP in chip_smoke.WINNER_SHAPES[1:]:
        cases[name] = (chip_smoke._fusion_candidates(gen, B, N, P, CAP, dev, "random"), P, CAP)
    cases["pallas_rmw contract (diag shapes)"] = chip_smoke._rmw_inputs(dev)
    H, W = 480, 640
    cases["480x640 N=2P"] = (chip_smoke._fusion_candidates(gen, 2, 2 * H * W, H * W, 16 * H * W, dev, "both ties"),
                             H * W, 16 * H * W)
    for cell, (colors, depths, K), options in chip_smoke.winner_paths():
        cases[f"{cell} main path, last fusion step"] = chip_smoke.main_path_winner_inputs(
            colors, depths, K, dev, **options)[-1]

    for name, (ins, P, CAP) in cases.items():
        B, N = ins[0].shape
        ref = pixel_winner_reference(*ins, P, CAP)
        bound_ms = 1e3 * (16 * B * N + 4 * B * P) / chip_smoke.HBM_BYTES_PER_S
        shape = f"{name} B={B} N={N} P={P}"
        chosen = winner_kernel.grid(B, N, P, most)

        def timed(tag, fn):
            got = fn()
            torch.cuda.synchronize()
            chip_smoke._check(torch.equal(got, ref), f"winner tiles {shape} {tag}: differs")
            ms = chip_smoke._time_ms(fn, reps=args.reps)
            us = _host_us(fn, args.reps)
            print(f"{shape}: {tag}: {ms:.6f} ms on the card, {us:.3f} us on the host, bound {bound_ms:.6f} ms",
                  flush=True)

        # the chosen grid through pixel_winner, as the parent's: the same
        # host path as the port's callers take
        def call_parent():
            return parent.pixel_winner(*ins, P, CAP)

        def call_chosen():
            return pixel_winner(*ins, P, CAP)

        if parent is not None:
            timed("parent", call_parent)
        for n in sorted(set(b for b in args.blocks if b <= most) | {chosen, most}):
            if n == chosen:
                timed(f"blocks={n} (chosen)", call_chosen)
            else:
                timed(f"blocks={n}", lambda: winner_kernel.launch(*ins, P, CAP, blocks=n))
        if parent is not None:
            timed(f"blocks={chosen} (chosen), again", call_chosen)
            timed("parent, again", call_parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
