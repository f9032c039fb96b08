"""What the drivers share: the port's system and the reference's options
built from a configuration file, and a cell's inputs from its traffic."""

from __future__ import annotations

import numpy as np
import torch

from .inputs.render import render_arcs


def system(config: dict, device):
    """The port's system (``PointFusion``) through its public constructor,
    with the configuration's options."""
    import gradslam_tpu_torch as port

    return {"PointFusion": port.PointFusion}[config["system"]](device=device, **config.get("options", {}))


def reference_options(config: dict):
    """The reference's :class:`~slam_bench.reference.Options`: upstream's
    defaults and any of the configuration's options by the same names."""
    from .reference import Options

    return Options(**config.get("options", {}))


def frames(run, arcs: int, length: int):
    """``arcs`` arcs of ``length`` frames of the traffic's loop at the
    configuration's frame size, drawn from the run's seed, on the card:
    (colors, depths, intrinsics, ground-truth poses)."""
    cfg, tr = run.config, run.workload["traffic"]
    pinhole = tuple(cfg["intrinsics"][k] for k in ("fx", "fy", "cx", "cy"))
    return render_arcs(run.seed, arcs, length, cfg["height"], cfg["width"], pinhole, tr["loop_frames"],
                       tr["radius_m"], tr["depth_warp"], run.device)


def draw(seed: int, salt: str, n: int) -> int:
    """A sample index in [0, n) drawn from the seed (``salt`` keeps draws
    for different purposes apart from each other and from the inputs')."""
    return int(np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, sum(salt.encode())]).integers(n))


def sync(device):
    """Waits for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(device):
    """A ``torch.profiler.profile`` of the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    return _profile(activities=acts)
