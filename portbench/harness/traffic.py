"""The class averages a run searches.

One general generator reads the configuration's image parameters (size,
pixel size, helix diameter, ball radius, band limit, noise) and the
traffic's stream of truths (the twist's range and hand, the rise's range,
the stack's size and the seed of its pool). Every run searches the same
pool of class averages, made from the traffic's pool seed, in an order
drawn from the run's seed (``ordered``): the set of images, and so the
work, is the same for every seed, and only its order changes. Each class
average is the projection of a helix of
Gaussian balls: one asymmetric unit of random balls, repeated along the
axis by the image's twist and rise, projected along the viewing axis,
band-limited, with Gaussian noise at a fraction of its foreground's
sigma. Everything is drawn on ``device`` from one torch.Generator, in a
few large calls, so that one seed gives the same stack.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Stack:
    images: list  # (ny, nx) float32 numpy, as a stack read into memory
    twists: np.ndarray  # the truths, degrees
    rises: np.ndarray  # Angstrom


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def _band_limit(img: torch.Tensor, apix: float, resolution: float) -> torch.Tensor:
    """A Gaussian low-pass that halves the amplitude at ``resolution`` A."""
    ny, nx = img.shape[-2:]
    fy = torch.fft.fftfreq(ny, d=apix, device=img.device)
    fx = torch.fft.fftfreq(nx, d=apix, device=img.device)
    r2 = fy[:, None] ** 2 + fx[None, :] ** 2
    g = torch.exp(-math.log(2.0) * r2 * resolution ** 2)
    return torch.fft.ifft2(torch.fft.fft2(img) * g).real


def make_stack(image: dict, truth: dict, n: int, seed: int, device) -> Stack:
    """n class averages of the configuration's ``image`` parameters with
    truths drawn from the traffic's ``truth``."""
    dev = torch.device(device)
    g = _generator(seed, dev)
    ny, nx, apix = int(image["ny"]), int(image["nx"]), float(image["apix"])
    radius = float(image["helical_diameter_A"]) / 2
    nb = int(image["balls_per_unit"])
    hand = float(truth.get("hand", 1))
    twists = hand * _uniform(g, n, *truth["twist_abs"], dev)
    rises = _uniform(g, n, *truth["rise"], dev)
    # the asymmetric unit: radius uniform over the disc's area, angle
    # uniform, height within one rise
    r = radius * torch.sqrt(torch.rand((n, nb), generator=g, device=dev, dtype=torch.float64))
    phi = 2 * math.pi * torch.rand((n, nb), generator=g, device=dev, dtype=torch.float64)
    z0 = (torch.rand((n, nb), generator=g, device=dev, dtype=torch.float64) - 0.5) * rises[:, None]
    noise = torch.randn((n, ny, nx), generator=g, device=dev, dtype=torch.float32)
    sigma2 = float(image["ball_radius_A"]) ** 2 / math.log(2.0)
    Y = (torch.arange(ny, device=dev, dtype=torch.float32) - ny // 2) * apix
    X = (torch.arange(nx, device=dev, dtype=torch.float32) - nx // 2) * apix
    images = []
    for i in range(n):
        imax = int(math.ceil(nx * apix / float(rises[i])))
        k = torch.arange(-imax, imax + 1, device=dev, dtype=torch.float64)
        ang = phi[i][None, :] + torch.deg2rad(twists[i] * k)[:, None]  # (copies, nb)
        y = (r[i][None, :] * torch.sin(ang)).reshape(-1).float()
        z = (z0[i][None, :] + k[:, None] * rises[i]).reshape(-1).float()
        img = torch.zeros((ny, nx), device=dev)
        for s in range(0, len(y), 512):
            dy = (Y[None, :, None] - y[s:s + 512, None, None]) ** 2
            dx = (X[None, None, :] - z[s:s + 512, None, None]) ** 2
            img += torch.exp(-(dy + dx) / sigma2).sum(dim=0)
        if image.get("band_limit_A"):
            img = _band_limit(img, apix, float(image["band_limit_A"]))
        fg = img[img.abs() > 1e-4 * img.abs().max()]
        img = img + float(image["noise_fraction"]) * fg.std() * noise[i]
        images.append(img)
    host = torch.stack(images).cpu().numpy()
    return Stack(images=[np.ascontiguousarray(a) for a in host],
                 twists=twists.cpu().numpy(), rises=rises.cpu().numpy())


def ordered(stack: Stack, seed: int) -> Stack:
    """The stack in an order drawn from ``seed``."""
    order = np.random.default_rng(int(seed) % (2 ** 63)).permutation(len(stack.images))
    return Stack(images=[stack.images[i] for i in order], twists=stack.twists[order],
                 rises=stack.rises[order])


def pool(image: dict, traffic: dict, device) -> Stack:
    """The traffic's pool of class averages."""
    return make_stack(image, traffic["truth"], int(traffic["stack_size"]),
                      int(traffic["pool_seed"]), device)


def warm_image(image: dict, traffic: dict, device):
    """A class average of the pool's kind outside the pool, for the
    warm-up."""
    return make_stack(image, traffic["truth"], 1, int(traffic["pool_seed"]) + 1,
                      device).images[0]
