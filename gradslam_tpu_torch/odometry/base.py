"""Odometry provider interface (PyTorch port of gradslam_tpu.odometry.base)."""

from __future__ import annotations

from abc import ABC, abstractmethod

__all__ = ["OdometryProvider"]


class OdometryProvider(ABC):
    """Abstract base of the odometry providers: each estimates the relative
    transform between two point sets or frames, without hidden state."""

    @abstractmethod
    def provide(self, *args, **kwargs):
        """Returns (B, 1, 4, 4) relative transforms."""
