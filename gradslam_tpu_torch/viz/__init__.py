"""Visualization exports (import-gated: plotly/open3d are optional; the
JAX package's exports, reading torch tensors).

Parity surface with the reference's viz methods
(Pointclouds.open3d :1239 / .plotly :1296, RGBDImages.plotly :764,
helpers in structures/structutils.py:127-178).
"""

from __future__ import annotations

import base64

import numpy as np

from .ply import _numpy, pointclouds_to_ply, write_ply

__all__ = [
    "write_ply",
    "pointclouds_to_ply",
    "pointclouds_open3d",
    "pointclouds_plotly",
    "rgbd_plotly",
    "numpy_to_plotly_image",
    "img_to_b64str",
]


def _require(modname):
    try:
        return __import__(modname)
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            f"{modname} is required for this visualization; install it or "
            "export the data with .points_list / numpy instead"
        ) from e


def pointclouds_open3d(pointclouds, index: int = 0):
    """Converts one batch element to an ``open3d.geometry.PointCloud``."""
    o3d = _require("open3d")
    pts = _numpy(pointclouds.points_list[index])
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts.astype(np.float64))
    if pointclouds.has_normals:
        pcd.normals = o3d.utility.Vector3dVector(
            _numpy(pointclouds.normals_list[index]).astype(np.float64)
        )
    if pointclouds.has_colors:
        colors = _numpy(pointclouds.colors_list[index]).astype(np.float64)
        if colors.max() > 1.5:
            colors = colors / 255.0
        pcd.colors = o3d.utility.Vector3dVector(np.clip(colors, 0, 1))
    return pcd


def pointclouds_plotly(
    pointclouds,
    index: int = 0,
    max_num_points: int = 200_000,
    point_size: int = 2,
    as_figure: bool = True,
):
    """Builds a plotly 3D scatter of one batch element."""
    plotly = _require("plotly")
    import plotly.graph_objects as go

    pts = _numpy(pointclouds.points_list[index])
    if len(pts) > max_num_points:
        stride = int(np.ceil(len(pts) / max_num_points))
        pts = pts[::stride]
    marker = dict(size=point_size)
    if pointclouds.has_colors:
        colors = _numpy(pointclouds.colors_list[index])
        if len(colors) > len(pts):
            stride = int(np.ceil(len(colors) / len(pts)))
            colors = colors[::stride][: len(pts)]
        if colors.max() <= 1.5:
            colors = colors * 255.0
        marker["color"] = [
            f"rgb({int(r)},{int(g)},{int(b)})" for r, g, b in colors
        ]
    trace = go.Scatter3d(
        x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers", marker=marker
    )
    if not as_figure:
        return trace
    fig = go.Figure(data=[trace])
    fig.update_layout(scene=dict(aspectmode="data"))
    return fig


def rgbd_plotly(rgbdimages, index: int = 0, ms_per_frame: int = 50):
    """Plotly animation of a frame sequence (rgb + depth panels)."""
    plotly = _require("plotly")
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots

    rgbd = rgbdimages.to_channels_last()
    rgb = _numpy(rgbd.rgb_image[index])
    depth = _numpy(rgbd.depth_image[index, ..., 0])
    L = rgb.shape[0]
    if rgb.max() <= 1.5:
        rgb = rgb * 255.0
    fig = make_subplots(rows=1, cols=2, subplot_titles=("rgb", "depth"))
    fig.add_trace(go.Image(z=rgb[0]), row=1, col=1)
    fig.add_trace(go.Heatmap(z=depth[0], colorscale="Viridis"), row=1, col=2)
    frames = [
        go.Frame(
            data=[
                go.Image(z=rgb[s]),
                go.Heatmap(z=depth[s], colorscale="Viridis"),
            ],
            name=str(s),
        )
        for s in range(L)
    ]
    fig.frames = frames
    fig.update_layout(
        updatemenus=[
            dict(
                type="buttons",
                buttons=[
                    dict(
                        label="Play",
                        method="animate",
                        args=[
                            None,
                            dict(frame=dict(duration=ms_per_frame)),
                        ],
                    )
                ],
            )
        ]
    )
    return fig


def numpy_to_plotly_image(img, name=None, is_depth=False, scale=None):
    """Wraps a numpy image as a plotly Image/Heatmap trace
    (reference structutils.py:127)."""
    _require("plotly")
    import plotly.graph_objects as go

    img = _numpy(img)
    if is_depth:
        return go.Heatmap(z=img, colorscale="Viridis", name=name)
    if img.max() <= 1.5:
        img = img * 255.0
    return go.Image(z=img, name=name)


def img_to_b64str(img, quality: int = 95) -> str:
    """JPEG-encodes an image to a base64 data URI
    (reference structutils.py:156)."""
    import cv2

    img = _numpy(img)
    if img.max() <= 1.5:
        img = img * 255.0
    img = img.astype(np.uint8)
    ok, buf = cv2.imencode(
        ".jpg", img[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), quality]
    )
    if not ok:
        raise ValueError("JPEG encoding failed")
    return "data:image/jpeg;base64," + base64.b64encode(buf).decode("ascii")
