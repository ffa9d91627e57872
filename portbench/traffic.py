"""The benchmark's inputs, made from ``--seed``.

:func:`synth_slices` is the recipe of ``benchmarks/gen_synth.py`` (a noisy
dark background, 1-2 bright filled ellipses, each with a ring at its
boundary) computed in bulk on the device with a seeded ``torch.Generator``,
never written to disk; the recipe's numbers come from a data file under
``traffic/``.  Masks are the classes 0 (background), 1 (ring) and 2
(interior): the reference's mask values {0, 128, 255} in sorted order.
:func:`seeded` gives each consumer of the seed (weights, slices, samples)
its own generator, so that one draws the same numbers whatever another
draws.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SLICE_KEYS", "seed_words", "seeded", "synth_slices"]

# the keys of a slices recipe that :func:`synth_slices` reads ("about"
# describes the recipe)
SLICE_KEYS = {"about", "height", "width", "background_mean", "background_std", "noise_std",
              "ellipses_min", "ellipses_max", "center_margin", "radius_min", "radius_max",
              "inner_add_min", "inner_add_max", "ring_add_min", "ring_add_max", "ring_outer"}

_CHUNK = 32  # slices made at once (a few hundred MiB of f32 work space at 512²)


def seed_words(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run seed ``seed`` (any whole number)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]).generate_state(2)
    return (int(state[0]) << 31 ^ int(state[1])) & (2**63 - 1)


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded for ``stream`` of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_words(seed, stream))
    return g


def _uniform(g: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def synth_slices(spec: dict, n: int, seed: int, device):
    """``n`` slices of ``spec`` -> (uint8 images (n, H, W), int64 classes (n, H, W)),
    both on ``device`` (stream 1 of the seed; the weights take stream 0)."""
    g = seeded(seed, 1, device)
    h, w = spec["height"], spec["width"]
    k_max = spec["ellipses_max"]
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    images, masks = [], []
    for start in range(0, n, _CHUNK):
        m = min(_CHUNK, n - start)
        count = torch.randint(spec["ellipses_min"], k_max + 1, (m,), generator=g, device=device)
        margin = spec["center_margin"]
        cy = _uniform(g, (m, k_max), margin, h - margin, device)
        cx = _uniform(g, (m, k_max), margin, w - margin, device)
        ry = _uniform(g, (m, k_max), spec["radius_min"], spec["radius_max"], device)
        rx = _uniform(g, (m, k_max), spec["radius_min"], spec["radius_max"], device)
        th = _uniform(g, (m, k_max), 0.0, float(np.pi), device)
        inner_add = _uniform(g, (m, k_max), spec["inner_add_min"], spec["inner_add_max"], device)
        ring_add = _uniform(g, (m, k_max), spec["ring_add_min"], spec["ring_add_max"], device)
        img = spec["background_mean"] + spec["background_std"] * torch.randn(
            (m, h, w), generator=g, device=device)
        mask = torch.zeros((m, h, w), dtype=torch.int64, device=device)
        for k in range(k_max):
            on = (count > k).view(m, 1, 1)
            c, s = torch.cos(th[:, k]).view(m, 1, 1), torch.sin(th[:, k]).view(m, 1, 1)
            dx, dy = xx - cx[:, k].view(m, 1, 1), yy - cy[:, k].view(m, 1, 1)
            u = (dx * c + dy * s) / rx[:, k].view(m, 1, 1)
            v = (-dx * s + dy * c) / ry[:, k].view(m, 1, 1)
            d = u * u + v * v
            inner = (d < 1.0) & on
            ring = (d < spec["ring_outer"]) & ~(d < 1.0) & on
            mask = torch.where(inner, 2, mask)
            mask = torch.where(ring & (mask == 0), 1, mask)
            img = img + inner * inner_add[:, k].view(m, 1, 1) + ring * ring_add[:, k].view(m, 1, 1)
        img = img + spec["noise_std"] * torch.randn((m, h, w), generator=g, device=device)
        images.append(img.clamp(0, 255).to(torch.uint8))
        masks.append(mask)
    return torch.cat(images), torch.cat(masks)
