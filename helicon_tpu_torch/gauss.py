"""Isotropic and anisotropic 2D Gaussian models.

Counterpart of ``helicon_tpu/gauss.py`` (host numpy, copied): its five
classes, each evaluated on a centred (ny, nx) grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "AnisotropicGaussian",
    "AnisotropicGaussianSet",
    "IsotropicGaussian",
    "IsotropicGaussianSet",
]


@dataclasses.dataclass
class IsotropicGaussian:
    """A single isotropic 2D Gaussian: center (y, x), sigma, amplitude."""

    center: tuple = (0.0, 0.0)
    sigma: float = 1.0
    amplitude: float = 1.0

    def evaluate(self, shape, apix: float = 1.0):
        ny, nx = shape
        y = (np.arange(ny) - ny // 2) * apix
        x = (np.arange(nx) - nx // 2) * apix
        Y, X = np.meshgrid(y, x, indexing="ij")
        r2 = (Y - self.center[0]) ** 2 + (X - self.center[1]) ** 2
        return self.amplitude * np.exp(-r2 / (2 * self.sigma**2))


@dataclasses.dataclass
class AnisotropicGaussian:
    """An anisotropic 2D Gaussian: center (y, x), sigmas (sy, sx),
    rotation (deg), amplitude."""

    center: tuple = (0.0, 0.0)
    sigmas: tuple = (1.0, 1.0)
    rotation: float = 0.0
    amplitude: float = 1.0

    def evaluate(self, shape, apix: float = 1.0):
        ny, nx = shape
        y = (np.arange(ny) - ny // 2) * apix
        x = (np.arange(nx) - nx // 2) * apix
        Y, X = np.meshgrid(y, x, indexing="ij")
        dy = Y - self.center[0]
        dx = X - self.center[1]
        a = np.deg2rad(self.rotation)
        u = dx * np.cos(a) + dy * np.sin(a)
        v = -dx * np.sin(a) + dy * np.cos(a)
        sy, sx = self.sigmas
        return self.amplitude * np.exp(
            -(u**2 / (2 * sx**2) + v**2 / (2 * sy**2))
        )


class _GaussianSet(list):
    def evaluate(self, shape, apix: float = 1.0):
        out = np.zeros(shape, np.float64)
        for g in self:
            out += g.evaluate(shape, apix)
        return out


class IsotropicGaussianSet(_GaussianSet):
    """A sum of isotropic Gaussians."""


class AnisotropicGaussianSet(_GaussianSet):
    """A sum of anisotropic Gaussians."""
