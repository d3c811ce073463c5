"""Scene kind "sphere_list": spheres listed one by one in the
configuration, each {"mat", "center", "radius"} and the material's own keys
("albedo", "fuzz", "ior", "emission")."""

from __future__ import annotations

MATERIALS = {"lambertian": 0, "metal": 1, "dielectric": 2, "emissive": 3}


def rows(spheres: list) -> list:
    """(center, radius, mat tag, albedo, fuzz, ior, emission) of each entry."""
    out = []
    for s in spheres:
        out.append((tuple(s["center"]), float(s["radius"]),
                    MATERIALS[s["mat"]], tuple(s.get("albedo", (0, 0, 0))),
                    min(float(s.get("fuzz", 0.0)), 1.0),
                    float(s.get("ior", 1.0)),
                    tuple(s.get("emission", (0, 0, 0)))))
    return out


def build(params: dict) -> dict:
    return {"spheres": rows(params["spheres"]), "mesh": None}
