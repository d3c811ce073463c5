"""Scene kind "book_cover_grid": the final scene of Shirley's 'Ray Tracing
in One Weekend' (section 13, random_scene): a ground sphere, a 22 x 22 grid
of small spheres of random material (80% Lambertian, 15% metal, 5% glass)
that keep clear of the metal hero, and three large spheres, drawn from a
seeded numpy Generator."""

from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


def build(params: dict) -> dict:
    rng = np.random.default_rng(int(params["seed"]))
    zero = (0.0, 0.0, 0.0)
    out = [((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0,
            1.0, zero)]
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               c + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                out.append((tuple(center), 0.2, LAMBERTIAN, tuple(albedo),
                            0.0, 1.0, zero))
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                fuzz = min(0.5 * rng.random(), 1.0)
                out.append((tuple(center), 0.2, METAL, tuple(albedo), fuzz,
                            1.0, zero))
            else:
                out.append((tuple(center), 0.2, DIELECTRIC, zero, 0.0, 1.5,
                            zero))
    out.append(((0.0, 1.0, 0.0), 1.0, DIELECTRIC, zero, 0.0, 1.5, zero))
    out.append(((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1), 0.0, 1.0,
                zero))
    out.append(((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0, 1.0,
                zero))
    return {"spheres": out, "mesh": None}
