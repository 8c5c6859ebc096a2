"""Polygons around their centres in the manner of Spider's polygon
generator (a centre from the distribution, 3 to ``max_verts`` vertices at
sorted random angles around it), each vertex at a random share
(drawn from ``jitter``) of the record's size (drawn from ``size``).
A frozen copy of the polygons of the port's ``generate("uniform")``: the
same draws in the same order."""
import numpy as np

from bench.harness.stores import POLYGON, centres, pad_last


def make(rng, n, p):
    mv = int(p["max_verts"])
    ctr = centres(rng, n, p)
    sizes = rng.uniform(*p["size"], size=n)
    nverts = rng.integers(3, mv + 1, size=n).astype(np.int32)
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, size=(n, mv)), axis=1)
    radii = sizes[:, None] * rng.uniform(*p["jitter"],
                                         size=(n, mv))
    verts = np.stack([ctr[:, 0:1] + radii * np.cos(angles),
                      ctr[:, 1:2] + radii * np.sin(angles)], -1)
    return pad_last(verts, nverts), nverts, POLYGON
