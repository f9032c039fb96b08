"""Times the KNN kernel's tile choices on one CUDA card.

    python tools/knn_tiles.py

For each of chip_smoke.py's timed KNN cases (the golden and ScanNet shapes,
each with 30% of the targets invalid and scattered, and with the main
path's valid prefix) and each (sources a lane, blocks a cluster) the
kernel takes, checks the kernel bit for bit against the plain version and
prints its device time beside the choice of ``knn_kernel.tiles``.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("knn_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from gradslam_tpu_torch.ops.knn import knn_kernel, knn_reference, prepare_targets

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    knn_kernel.load()
    gen = np.random.default_rng(0)
    for name, B, S, T, n_valid in (("golden", 2, 1200, 5120, 1776), ("scannet", 2, 4800, 19456, 6229)):
        src = torch.from_numpy(gen.uniform(-2, 2, (B, S, 3)).astype(np.float32)).to(dev)
        tgt = torch.from_numpy(gen.uniform(-2, 2, (B, T, 3)).astype(np.float32)).to(dev)
        layouts = {
            "30% invalid": torch.from_numpy(gen.random((B, T)) >= 0.3).to(dev),
            f"prefix {n_valid}": (torch.arange(T, device=dev) < n_valid).expand(B, T),
        }
        for layout, val in layouts.items():
            prep = prepare_targets(tgt, val)
            d_p, i_p = knn_reference(src, tgt, val)
            bound_ms, _ = chip_smoke._knn_bound(src, int(prep.limit.sum()), int(val.sum()))
            chosen = knn_kernel.tiles(B, S, T)
            for k in (2, 4):
                for splits in (1, 2, 4, 6, 8):
                    d, i = knn_kernel.launch(src, prep.packed, prep.limit, k, splits)
                    torch.cuda.synchronize()
                    chip_smoke._check(torch.equal(d, d_p) and torch.equal(i, i_p),
                                      f"knn tiles k={k} splits={splits} {name} {layout}: differs")
                    ms = chip_smoke._time_ms(
                        lambda: knn_kernel.launch(src, prep.packed, prep.limit, k, splits), reps=50)
                    mark = " (chosen)" if (k, splits) == chosen else ""
                    print(f"{name} B={B} S={S} T={T} {layout}: k={k} splits={splits}: {ms:.6f} ms, "
                          f"bound {bound_ms:.6f} ms{mark}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
