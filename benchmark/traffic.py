"""The one generator of the benchmark's traffic: the cameras a cell's
requests ask for, in order, from the cell's "traffic" parameters and the
run's seed. Every seed asks for the same kind of work in another order.

Parameters (workloads/<cell>.json, "traffic"):
  cameras  "preset": the configuration's own camera, every request;
           "orbit": cameras on the configuration's orbit (camera.orbit
           radius and height, looking at the origin, up +z), at azimuths
           start_deg + i * step_deg for i < count.
  order    "cycle": the orbit in order from a seeded start, over and over;
           "ring_walk": from a seeded start, each next camera a ring
           neighbour, +1 or -1 drawn from the seed;
           "golden": a new azimuth every request, a seeded start advanced
           by the golden angle, so no azimuth repeats within a run.
A camera is a dict: eye, center, up, fov_y_degrees, width, height; with
"index" the orbit slot it takes (None for a "golden" camera).
"""
from __future__ import annotations

import math
import random

GOLDEN_DEG = 180.0 * (3.0 - math.sqrt(5.0))


def _camera(cfg_cam: dict, eye, index=None) -> dict:
    return {"eye": [float(x) for x in eye],
            "center": list(cfg_cam["center"]), "up": list(cfg_cam["up"]),
            "fov_y_degrees": cfg_cam["fov_y_degrees"],
            "width": cfg_cam["width"], "height": cfg_cam["height"],
            "index": index}


def orbit_eye(cfg_cam: dict, deg: float):
    radius, height = cfg_cam["orbit_radius"], cfg_cam["orbit_height"]
    r_xy = math.sqrt(max(radius * radius - height * height, 1e-6))
    t = math.radians(deg)
    return (r_xy * math.cos(t), r_xy * math.sin(t), height)


class Traffic:
    """The request stream of one run."""

    def __init__(self, spec: dict, cfg_cam: dict, seed: int):
        self.spec, self.cam = spec, cfg_cam
        self.rng = random.Random(seed)
        self.kind, self.order = spec["cameras"], spec.get("order", "cycle")
        self.ring = []
        if self.kind == "orbit" and self.order != "golden":
            self.ring = [_camera(cfg_cam, orbit_eye(
                cfg_cam, spec["start_deg"] + i * spec["step_deg"]), i)
                for i in range(int(spec["count"]))]
        elif self.kind not in ("preset", "orbit"):
            raise ValueError(f"unknown cameras {self.kind!r}")
        self.pos = self.rng.randrange(len(self.ring)) if self.ring else 0
        self.deg = self.rng.uniform(0.0, 360.0)
        self.first = True

    def warmup(self) -> dict:
        """A camera of the same kind that the run never asks for (for a
        "golden" stream) or the ring's first (otherwise)."""
        if self.kind == "preset":
            return _camera(self.cam, self.cam["eye"])
        if self.order == "golden":
            return _camera(self.cam, orbit_eye(self.cam,
                                               self.deg - GOLDEN_DEG))
        return self.ring[0]

    def next(self) -> dict:
        if self.kind == "preset":
            return _camera(self.cam, self.cam["eye"])
        if self.order == "golden":
            cam = _camera(self.cam, orbit_eye(self.cam, self.deg))
            self.deg = (self.deg + GOLDEN_DEG) % 360.0
            return cam
        if not self.first:
            step = 1 if self.order == "cycle" else self.rng.choice((-1, 1))
            self.pos = (self.pos + step) % len(self.ring)
        self.first = False
        return self.ring[self.pos]
